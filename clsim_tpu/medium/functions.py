"""Wavelength-dependent optical property functions.

These are the equivalents of the reference's dual C++/OpenCL
``I3CLSimFunction`` objects (reference public/clsim/function/I3CLSimFunction.h).
Instead of codegen-into-OpenCL-strings, each model is a pure jnp function of
(params, wavelength) where params is a pytree of (potentially per-layer,
potentially differentiable) leaves.  All wavelengths are in **nanometers**,
all returned lengths in **meters**.

Formulas (verified against the reference implementations):
  * absorption_length_icecube:
      1 / ( (D*aDust400 + E) * x^-kappa + A*exp(-B/x) * (1 + 0.01*deltaTau) )
      with x = lambda[nm]
      (reference private/clsim/function/I3CLSimFunctionAbsLenIceCube.cxx:63-67)
  * scattering_length_icecube:
      1 / ( b400 * (x/400)^-alpha )
      (reference private/clsim/function/I3CLSimFunctionScatLenIceCube.cxx:53-57)
  * refractive index (phase/group):
      quartic polynomials in x = lambda[um]
      (reference private/clsim/function/I3CLSimFunctionRefIndexIceCube.cxx:84-102)
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# IceCube deep-ice absorption
# ---------------------------------------------------------------------------

class AbsLenParams(NamedTuple):
    """Parameters of the 6-parameter IceCube absorption model.

    ``a_dust400`` and ``delta_tau`` may be scalars or per-layer arrays; the
    global shape parameters are scalars.  All leaves are differentiable.
    """
    kappa: jnp.ndarray
    A: jnp.ndarray
    B: jnp.ndarray
    D: jnp.ndarray
    E: jnp.ndarray
    a_dust400: jnp.ndarray   # dust absorption coefficient at 400nm [1/m]
    delta_tau: jnp.ndarray   # temperature correction [K]


def absorption_inv_length_icecube(p: AbsLenParams, wlen_nm):
    """Inverse absorption length [1/m]; broadcasting in (params, wlen)."""
    x = jnp.asarray(wlen_nm)
    dust_term = (p.D * p.a_dust400 + p.E) * x ** (-p.kappa)
    ice_term = p.A * jnp.exp(-p.B / x) * (1.0 + 0.01 * p.delta_tau)
    return dust_term + ice_term


def absorption_length_icecube(p: AbsLenParams, wlen_nm):
    return 1.0 / absorption_inv_length_icecube(p, wlen_nm)


def abs_separable_coeffs(kappa, A, B, D, E, wlen_nm):
    """Separable decomposition of the inverse absorption length.

    1/l_abs(layer, lambda) = pa(lambda)*a_dust400[layer]
                           + qa(lambda)
                           + ra(lambda)*delta_tau[layer]

    This rank-structure is what makes the layered-ice optical-depth walk a
    fixed-trip vector loop (see propagate/engine.py) instead of the
    reference's per-layer while loop (propagation_kernel.c.cl:646-676).
    """
    x = jnp.asarray(wlen_nm)
    xk = x ** (-kappa)
    ebx = A * jnp.exp(-B / x)
    pa = D * xk
    qa = E * xk + ebx
    ra = 0.01 * ebx
    return pa, qa, ra


# ---------------------------------------------------------------------------
# IceCube deep-ice geometric scattering
# ---------------------------------------------------------------------------

class ScatLenParams(NamedTuple):
    alpha: jnp.ndarray
    b400: jnp.ndarray        # scattering coefficient at 400nm [1/m] (NOT the
                             # "effective" b_e400 -- see ice_parser)


def scattering_inv_length_icecube(p: ScatLenParams, wlen_nm):
    x = jnp.asarray(wlen_nm)
    return p.b400 * (x / 400.0) ** (-p.alpha)


def scattering_length_icecube(p: ScatLenParams, wlen_nm):
    return 1.0 / scattering_inv_length_icecube(p, wlen_nm)


def scat_separable_coeff(alpha, wlen_nm):
    """1/l_sca(layer, lambda) = gs(lambda) * b400[layer]."""
    x = jnp.asarray(wlen_nm)
    return (x / 400.0) ** (-alpha)


# ---------------------------------------------------------------------------
# Refractive index (IceCube parameterization)
# ---------------------------------------------------------------------------

class RefIndexParams(NamedTuple):
    """Quartic polynomial coefficients in x = lambda[um] for the phase index
    and for the group-index correction factor (n_group = n_phase * corr)."""
    n: jnp.ndarray   # (5,) phase index coefficients n0..n4
    g: jnp.ndarray   # (5,) group correction coefficients g0..g4


# default coefficients for deep South Pole ice
# (reference private/clsim/function/I3CLSimFunctionRefIndexIceCube.cxx defaults,
#  the standard "SPICE" dispersion parameterization).
# numpy, NOT jnp: module-scope device arrays would initialize the XLA
# backend at `import clsim_tpu`, which breaks jax.distributed.initialize
# on a multi-host cluster (it must run before any backend touch)
DEFAULT_ICE_REF_INDEX = RefIndexParams(
    n=np.array([1.55749, -1.57988, 3.99993, -4.68271, 2.09354], np.float32),
    g=np.array([1.227106, -0.954648, 1.42568, -0.711832, 0.0], np.float32),
)


def _poly4(c, x):
    return c[0] + x * (c[1] + x * (c[2] + x * (c[3] + x * c[4])))


def phase_ref_index(p: RefIndexParams, wlen_nm):
    x = jnp.asarray(wlen_nm) * 1e-3  # nm -> um
    return _poly4(p.n, x)


def group_ref_index(p: RefIndexParams, wlen_nm):
    x = jnp.asarray(wlen_nm) * 1e-3
    return _poly4(p.n, x) * _poly4(p.g, x)


# ---------------------------------------------------------------------------
# Sea water (Antares / KM3NeT) -- Quan & Fry refractive index
# ---------------------------------------------------------------------------

class QuanFryParams(NamedTuple):
    salinity: jnp.ndarray      # [psu], e.g. 38.44
    temperature: jnp.ndarray   # [deg C], e.g. 13.1
    pressure: jnp.ndarray      # [atm], e.g. 240.0


def phase_ref_index_quan_fry(p: QuanFryParams, wlen_nm):
    """Quan & Fry (1995) empirical sea-water phase refractive index with the
    pressure extension used by Antares
    (reference private/clsim/function/I3CLSimFunctionRefIndexQuanFry.cxx).
    """
    S = p.salinity
    T = p.temperature
    P = p.pressure
    x = jnp.asarray(wlen_nm)
    # the standard Quan&Fry coefficient set incl. pressure correction
    n0, n1, n2, n3, n4 = 1.31405, 1.45e-5, 1.779e-4, -1.05e-6, 1.6e-8
    n5, n6, n7, n8 = -2.02e-6, 15.868, 0.01155, -0.00423
    n9, n10 = -4382.0, 1.1455e6
    a01 = (n0 + (n2 + n3 * T + n4 * T * T) * S + n5 * T * T
           + n1 * (P - 1.0) * 1.01325)
    a2 = n6 + n7 * S + n8 * T
    return a01 + a2 / x + n9 / (x * x) + n10 / (x * x * x)


def group_ref_index_quan_fry(p: QuanFryParams, wlen_nm):
    """Group index from the phase index and its analytic derivative:
    n_g = n_p / (1 + (lambda/n_p) dn_p/dlambda)."""
    x = jnp.asarray(wlen_nm)
    S = p.salinity
    T = p.temperature
    n6, n7, n8 = 15.868, 0.01155, -0.00423
    n9, n10 = -4382.0, 1.1455e6
    np_ = phase_ref_index_quan_fry(p, x)
    a2 = n6 + n7 * S + n8 * T
    dnp = -a2 / (x * x) - 2.0 * n9 / (x ** 3) - 3.0 * n10 / (x ** 4)
    return np_ / (1.0 + (x / np_) * dnp)


# ---------------------------------------------------------------------------
# Antares particulate scattering (Kopelevich model)
# ---------------------------------------------------------------------------

class ScatLenParticParams(NamedTuple):
    vol_conc_small: jnp.ndarray  # [ppm], e.g. 0.0075
    vol_conc_large: jnp.ndarray  # [ppm], e.g. 0.0075


def scattering_inv_length_partic(p: ScatLenParticParams, wlen_nm):
    """Inverse particulate+water scattering length [1/m] in sea water
    (reference private/clsim/function/I3CLSimFunctionScatLenPartic.cxx, the
    Kopelevich small/large particle volume-concentration model)."""
    x550 = 550.0 / jnp.asarray(wlen_nm)
    b_water = 0.0017 * x550 ** 4.3
    b_small = 1.34 * p.vol_conc_small * x550 ** 1.7
    b_large = 0.312 * p.vol_conc_large * x550 ** 0.3
    return b_water + b_small + b_large


# ---------------------------------------------------------------------------
# Generic function models
# ---------------------------------------------------------------------------

class TableParams(NamedTuple):
    """Equidistantly-sampled table with linear interpolation (the equivalent of
    the reference's I3CLSimFunctionFromTable in equal-spacing mode)."""
    first_x: jnp.ndarray
    dx: jnp.ndarray
    values: jnp.ndarray  # (n,)


def eval_table(t: TableParams, x):
    xi = (jnp.asarray(x) - t.first_x) / t.dx
    n = t.values.shape[0]
    i0 = jnp.clip(jnp.floor(xi).astype(jnp.int32), 0, n - 2)
    frac = jnp.clip(xi - i0.astype(xi.dtype), 0.0, 1.0)
    v0 = t.values[i0]
    v1 = t.values[i0 + 1]
    return v0 + frac * (v1 - v0)


def eval_polynomial(coeffs, x):
    """Horner evaluation of sum_i coeffs[i] * x^i (the equivalent of the
    reference's I3CLSimFunctionPolynomial, used for DOM angular sensitivity)."""
    x = jnp.asarray(x)
    out = jnp.zeros_like(x) + coeffs[-1]
    for c in coeffs[-2::-1]:
        out = out * x + c
    return out
