"""Ice-layer tilt: z-shift scalar field over (distance-along-tilt-azimuth, z).

Equivalent of the reference's I3CLSimScalarFieldIceTiltZShift
(private/clsim/function/I3CLSimScalarFieldIceTiltZShift.cxx:145-285, data
loading python/util/GetIceTiltZShift.py:40-61).  The photon's effective z for
medium-layer lookup is z - tilt_z_shift(x, y, z).

The interpolation semantics exactly mirror the reference's generated device
code: bilinear interpolation over a uniform z grid and a small non-uniform
distance grid, with linear extrapolation outside the distance range (the
generated OpenCL code's frac_at_lower may leave [0,1]) and clamped-index
extrapolation in z.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..pytree import register_static_fields


class TiltParams(NamedTuple):
    distances: jnp.ndarray    # (nd,) distances from origin along tilt azimuth [m]
    first_z: jnp.ndarray      # () first z coordinate of the grid [m]
    z_spacing: jnp.ndarray    # () uniform z spacing [m]
    z_corrections: jnp.ndarray  # (nd, nz) z-shift values [m]
    azimuth_cos: jnp.ndarray  # () cos of tilt direction azimuth (225 deg default)
    azimuth_sin: jnp.ndarray
    enabled: bool = True      # static; False -> zero shift


register_static_fields(TiltParams, ["enabled"])


def tilt_z_shift(p: TiltParams, x, y, z):
    if not p.enabled:
        return jnp.zeros_like(z)
    from ..ops.lookup import onehot_gather
    nd, nz = p.z_corrections.shape

    z_rescaled = (z - p.first_z) / p.z_spacing
    k = jnp.clip(jnp.floor(z_rescaled).astype(jnp.int32), 0, nz - 2)
    fz_above = z_rescaled - k.astype(z_rescaled.dtype)
    fz_below = 1.0 - fz_above

    nr = p.azimuth_cos * x + p.azimuth_sin * y

    # first j in [1, nd-1] with nr < distances[j], else nd-1
    j = jnp.clip(jnp.searchsorted(p.distances, nr, side="right"), 1, nd - 1)

    # fetch the four bilinear corners + the distance pair in one lookup
    # over the (nd-1)*(nz-1) cell table
    zc = p.z_corrections
    cell = jnp.stack([
        jnp.repeat(p.distances[:-1], nz - 1),
        jnp.repeat(p.distances[1:], nz - 1),
        zc[:-1, :-1].reshape(-1), zc[:-1, 1:].reshape(-1),
        zc[1:, :-1].reshape(-1), zc[1:, 1:].reshape(-1),
    ], axis=1)  # ((nd-1)*(nz-1), 6)
    flat = (j - 1) * (nz - 1) + k
    rows = onehot_gather(cell, flat)
    d_lo, d_hi = rows[..., 0], rows[..., 1]
    q_ll, q_lh, q_hl, q_hh = rows[..., 2], rows[..., 3], rows[..., 4], rows[..., 5]

    frac_lo = (d_hi - nr) / (d_hi - d_lo)
    frac_hi = 1.0 - frac_lo
    val_lo = q_lh * fz_above + q_ll * fz_below
    val_hi = q_hh * fz_above + q_hl * fz_below
    return val_hi * frac_hi + val_lo * frac_lo


def load_tilt(tilt_par_path, tilt_dat_path, detector_center_depth,
              azimuth=225.0 * np.pi / 180.0):
    """Build TiltParams from PPC tilt.par/tilt.dat files.

    File contract (reference python/util/GetIceTiltZShift.py:46-61):
    tilt.par column 1 = distance from origin along tilt azimuth per map line;
    tilt.dat column 0 = depth, columns 1..nd = z correction per distance; depth
    rows are converted to ascending z via z = center_depth - depth and flipped.
    """
    distances = np.loadtxt(tilt_par_path, unpack=True)[1]
    dat = np.loadtxt(tilt_dat_path, unpack=True)
    zcoords = (detector_center_depth - dat[0])[::-1]
    zshift = np.array([dat[i + 1][::-1] for i in range(len(distances))])

    spacing = np.diff(zcoords)
    if not np.allclose(spacing, spacing[0], atol=1e-6):
        raise ValueError("tilt.dat depth grid is not uniform")

    return TiltParams(
        distances=jnp.asarray(distances, jnp.float32),
        first_z=jnp.asarray(zcoords[0], jnp.float32),
        z_spacing=jnp.asarray(spacing[0], jnp.float32),
        z_corrections=jnp.asarray(zshift, jnp.float32),
        azimuth_cos=jnp.asarray(np.cos(azimuth), jnp.float32),
        azimuth_sin=jnp.asarray(np.sin(azimuth), jnp.float32),
        enabled=True,
    )


def disabled_tilt():
    z = jnp.zeros((), jnp.float32)
    return TiltParams(
        distances=jnp.zeros((2,), jnp.float32),
        first_z=z, z_spacing=jnp.ones((), jnp.float32),
        z_corrections=jnp.zeros((2, 2), jnp.float32),
        azimuth_cos=jnp.ones((), jnp.float32), azimuth_sin=z,
        enabled=False,
    )


def numpy_tilt_z_shift(distances, zcoords, zshift, azimuth, x, y, z):
    """float64 numpy oracle replicating the reference device code verbatim."""
    nd = len(distances)
    nz = len(zcoords)
    first_z = zcoords[0]
    spacing = zcoords[1] - zcoords[0]
    z_rescaled = (z - first_z) / spacing
    k = int(np.clip(np.floor(z_rescaled), 0, nz - 2))
    fz_above = z_rescaled - k
    fz_below = 1.0 - fz_above
    lnx, lny = np.cos(azimuth), np.sin(azimuth)
    nr = lnx * x + lny * y
    for j in range(1, nd):
        if (nr < distances[j]) or (j == nd - 1):
            w = distances[j] - distances[j - 1]
            frac_lo = (distances[j] - nr) / w
            frac_hi = 1.0 - frac_lo
            val_lo = zshift[j - 1][k + 1] * fz_above + zshift[j - 1][k] * fz_below
            val_hi = zshift[j][k + 1] * fz_above + zshift[j][k] * fz_below
            return val_hi * frac_hi + val_lo * frac_lo
    return 0.0
