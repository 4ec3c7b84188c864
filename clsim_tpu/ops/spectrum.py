"""Cherenkov spectrum, wavelength-bias importance sampling, and the
Frank-Tamm photon yield integral.

This implements the reference's central wavelength-bias contract
(SURVEY.md section 2.5): photon wavelengths are drawn from the bias-weighted
Cherenkov spectrum bias(lambda) * dN/dlambda, the step yield is the
bias-weighted Frank-Tamm integral, and at detection the recorded weight is
step.weight / bias(lambda) (propagation_kernel.c.cl:370).

The sampler is a linear-interpolated inverse-CDF table exactly like the
reference's I3CLSimRandomValueInterpolatedDistribution built by
makeCherenkovWavelengthGenerator (private/clsim/I3CLSimModuleHelper.cxx:176-300).
All tables are differentiable w.r.t. the underlying medium / bias parameters.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..constants import TWO_PI_OVER_137
from ..medium import functions as F
from .samplers import build_interpolated_dist, sample_interpolated_dist


def cherenkov_yield_density(ref_index: F.RefIndexParams, wlen_nm, beta=1.0):
    """dN/(dx dlambda) up to units: 2*pi*alpha_fs * (1 - 1/(beta n)^2)/lambda^2,
    with lambda in nm the result is photons/(m nm) after the 1e9 nm->m factor
    (reference I3CLSimModuleHelper.cxx:52-63)."""
    n = F.phase_ref_index(ref_index, wlen_nm)
    return TWO_PI_OVER_137 * (1.0 - 1.0 / (beta * n) ** 2) * 1e9 / (wlen_nm * wlen_nm)


def photons_per_meter(ref_index: F.RefIndexParams,
                      bias_wlen_nm, bias_values,
                      min_wlen_nm: float, max_wlen_nm: float,
                      n_points: int = 1024, beta: float = 1.0):
    """Bias-weighted Frank-Tamm integral: number of Cherenkov photons emitted
    per meter of beta=1 track, counting only bias-sampled photons.

    Equivalent of NumberOfPhotonsPerMeter
    (private/clsim/I3CLSimLightSourceToStepConverterUtils.cxx:71-106) but as a
    differentiable trapezoid quadrature instead of GSL QAG.  `bias_wlen_nm`/
    `bias_values` give the bias curve as a table (linearly interpolated); pass
    bias_values=None for an unbiased yield.
    """
    wl = jnp.linspace(min_wlen_nm, max_wlen_nm, n_points)
    dens = jnp.maximum(cherenkov_yield_density(ref_index, wl, beta), 0.0)
    if bias_values is not None:
        bias = jnp.interp(wl, jnp.asarray(bias_wlen_nm), jnp.asarray(bias_values))
        dens = dens * bias
    return jnp.trapezoid(dens, wl)


class WavelengthSpectrum(NamedTuple):
    """Inverse-CDF sampling tables for one emission spectrum, plus the bias
    curve needed to unweight at detection."""
    x: jnp.ndarray       # (n,) wavelengths [nm]
    acu: jnp.ndarray     # (n,) normalized CDF
    beta: jnp.ndarray    # (n,) normalized density
    bias_x: jnp.ndarray  # bias table for getWavelengthBias(lambda)
    bias_y: jnp.ndarray


def _np_interpolated_dist(x, y):
    """Host-side (numpy) version of samplers.build_interpolated_dist; spectrum
    tables are fixed setup data, so building them on the host avoids dozens
    of tiny device compiles."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    widths = x[1:] - x[:-1]
    segs = widths * (y[1:] + y[:-1]) / 2.0
    acu = np.concatenate([[0.0], np.cumsum(segs)])
    total = acu[-1]
    return (x.astype(np.float32), (acu / total).astype(np.float32),
            (y / total).astype(np.float32))


def make_cherenkov_spectrum(ref_index: F.RefIndexParams,
                            min_wlen_nm: float, max_wlen_nm: float,
                            bias_wlen_nm=None, bias_values=None,
                            step_nm: float = 10.0) -> WavelengthSpectrum:
    """Build the (biased) Cherenkov wavelength sampler (host-side numpy).

    Mirrors makeCherenkovWavelengthGenerator: if the bias is a table, use its
    binning; otherwise make a ~10nm grid over the medium range
    (I3CLSimModuleHelper.cxx:224-300)."""
    if bias_wlen_nm is not None:
        wl = np.asarray(bias_wlen_nm, np.float64)
        bias = np.asarray(bias_values, np.float64)
    else:
        n_points = int((max_wlen_nm - min_wlen_nm) / step_nm) + 2
        wl = np.linspace(min_wlen_nm, max_wlen_nm, n_points)
        bias = np.ones_like(wl)
    n = np.asarray(F.phase_ref_index(
        F.RefIndexParams(n=np.asarray(ref_index.n), g=np.asarray(ref_index.g)), wl))
    dens = TWO_PI_OVER_137 * (1.0 - 1.0 / (n * n)) * 1e9 / (wl * wl)
    x, acu, beta = _np_interpolated_dist(wl, bias * dens)
    return WavelengthSpectrum(x=x, acu=acu, beta=beta,
                              bias_x=wl.astype(np.float32),
                              bias_y=bias.astype(np.float32))


def make_tabulated_spectrum(wlen_nm, density,
                            bias_wlen_nm=None, bias_values=None) -> WavelengthSpectrum:
    """Sampler for an arbitrary tabulated emission spectrum (flasher LEDs),
    optionally multiplied by the generation bias (the equivalent of
    makeWavelengthGenerator, I3CLSimModuleHelper.cxx:74-170)."""
    wl = np.asarray(wlen_nm, np.float64)
    dens = np.asarray(density, np.float64)
    if bias_values is not None:
        bias = np.interp(wl, np.asarray(bias_wlen_nm), np.asarray(bias_values))
        bias_x = np.asarray(bias_wlen_nm, np.float32)
        bias_y = np.asarray(bias_values, np.float32)
    else:
        bias = np.ones_like(wl)
        bias_x, bias_y = wl.astype(np.float32), bias.astype(np.float32)
    x, acu, beta = _np_interpolated_dist(wl, dens * bias)
    return WavelengthSpectrum(x=x, acu=acu, beta=beta, bias_x=bias_x, bias_y=bias_y)


def sample_wavelength(spec: WavelengthSpectrum, u):
    return sample_interpolated_dist((spec.x, spec.acu, spec.beta), u)


def wavelength_bias(spec: WavelengthSpectrum, wlen_nm):
    """getWavelengthBias(lambda): linear interp of the bias table; the saved
    photon weight is step.weight / bias (propagation_kernel.c.cl:370)."""
    return jnp.interp(wlen_nm, spec.bias_x, spec.bias_y)


class SpectrumTable(NamedTuple):
    """Stacked per-source-type spectra (index 0 = Cherenkov, >=1 flashers) --
    the equivalent of I3CLSimSpectrumTable + the kernel's generateWavelength
    dispatch (public/clsim/I3CLSimSpectrumTable.h, propagation_kernel.c.cl:153-183).
    All member tables must share a common length; pad with repeats."""
    x: jnp.ndarray       # (n_spectra, n)
    acu: jnp.ndarray     # (n_spectra, n)
    beta: jnp.ndarray    # (n_spectra, n)
    bias_x: jnp.ndarray  # (nb,)   (bias is shared: the DOM acceptance)
    bias_y: jnp.ndarray  # (nb,)


def stack_spectra(spectra) -> SpectrumTable:
    n = max(np.shape(s.x)[0] for s in spectra)

    def pad(a):
        a = np.asarray(a)
        if a.shape[0] == n:
            return a
        return np.concatenate([a, np.repeat(a[-1:], n - a.shape[0], 0)])

    return SpectrumTable(
        x=np.stack([pad(s.x) for s in spectra]),
        acu=np.stack([pad(s.acu) for s in spectra]),
        beta=np.stack([pad(s.beta) for s in spectra]),
        bias_x=np.asarray(spectra[0].bias_x), bias_y=np.asarray(spectra[0].bias_y))


def sample_wavelength_dispatch(table: SpectrumTable, source_type, u):
    """Sample lambda for per-photon source types (0=Cherenkov, >=1 flasher).

    The segment index within each spectrum comes from a
    dense CDF comparison; the per-segment coefficients (x0, x1, beta0, beta1,
    acu0) come from one one-hot matmul over the stacked
    (n_spectra * (n-1), 5) coefficient table (see ops/lookup.py)."""
    from .lookup import onehot_gather

    n_spectra, n = table.x.shape
    if n_spectra == 1:
        acu = jnp.broadcast_to(table.acu[0], u.shape + (n,))
        seg_base = jnp.zeros_like(u, dtype=jnp.int32)
    else:
        acu = onehot_gather(table.acu, source_type)
        seg_base = source_type * (n - 1)
    k = jnp.clip(jnp.sum((acu <= u[..., None]).astype(jnp.int32), axis=-1) - 1,
                 0, n - 2)

    coeff = jnp.stack([
        table.x[:, :-1], table.x[:, 1:],
        table.beta[:, :-1], table.beta[:, 1:],
        table.acu[:, :-1],
    ], axis=-1).reshape(n_spectra * (n - 1), 5)
    rows = onehot_gather(coeff, seg_base + k)
    x0, x1, b, b1, acu0 = (rows[..., i] for i in range(5))
    slope = (b1 - b) / (x1 - x0)
    dy = u - acu0
    eps = 1e-20
    s_zero = jnp.abs(slope) < eps
    b_zero = jnp.abs(b) < eps
    safe_slope = jnp.where(s_zero, 1.0, slope)
    safe_b = jnp.where(b_zero, 1.0, b)
    r_full = x0 + (jnp.sqrt(jnp.maximum(dy * 2.0 * safe_slope / (safe_b * safe_b) + 1.0, 0.0)) - 1.0) * safe_b / safe_slope
    r_bz = x0 + jnp.sqrt(jnp.maximum(2.0 * dy / safe_slope, 0.0))
    r_sz = x0 + dy / safe_b
    return jnp.where(b_zero & s_zero, x0,
                     jnp.where(b_zero, r_bz, jnp.where(s_zero, r_sz, r_full)))
