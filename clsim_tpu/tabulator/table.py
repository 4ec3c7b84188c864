"""Photon-table generation (the reference's TABULATE mode).

Equivalent of I3CLSimStepToTableConverter + the #ifdef TABULATE branch of the
propagation kernel (propagation_kernel.c.cl:226-304, 540-785): photons are
propagated for a fixed number of absorption lengths (no detector collision);
every `step_length` (1 m) along each scattering segment a table entry is
deposited at the source-relative spherical coordinates with weight

    w * angular_acceptance(dir_z) * exp(-(depth + frac * stepDepth))

(survival probability in absorption lengths, linearly interpolated within
the segment).  The first sub-step of each photon is randomized to decorrelate
the comb from the emission point (kernel:562).

Normalization divides each spatial cell by bin_volume/(step_length*dom_area)
(I3CLSimStepToTableConverter.cxx:513-540).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import PI
from ..geometry import DetectorGeometry
from ..medium.properties import MediumProperties
from ..medium.anisotropy import abs_len_scaling
from ..ops import rng
from ..ops.spectrum import SpectrumTable
from ..propagate import engine as E
from ..types import PropagationConfig, StepBatch
from .axes import SphericalAxes


class ReferenceSource(NamedTuple):
    """Source frame for the table coordinates (I3CLSimReferenceParticle):
    position, direction, and a perpendicular reference direction."""
    pos: jnp.ndarray      # (3,)
    time: jnp.ndarray     # ()
    dir: jnp.ndarray      # (3,) unit
    perp: jnp.ndarray     # (3,) unit, perpendicular to dir


def make_reference_source(x, y, z, t, zenith, azimuth) -> ReferenceSource:
    """Build the source frame like the tabulator does from a particle."""
    d = np.array([-np.sin(zenith) * np.cos(azimuth),
                  -np.sin(zenith) * np.sin(azimuth),
                  -np.cos(zenith)])
    # a perpendicular direction (the reference uses the cross with z unless
    # degenerate)
    up = np.array([0.0, 0.0, 1.0])
    perp = np.cross(d, up)
    if np.linalg.norm(perp) < 1e-9:
        perp = np.array([1.0, 0.0, 0.0])
    perp = perp / np.linalg.norm(perp)
    return ReferenceSource(pos=jnp.asarray([x, y, z], jnp.float32),
                           time=jnp.asarray(t, jnp.float32),
                           dir=jnp.asarray(d, jnp.float32),
                           perp=jnp.asarray(perp, jnp.float32))


def _cylindrical_coords(px, py, pz, pt, source: ReferenceSource,
                        min_inv_groupvel, tan_theta_c, dirp=None):
    """Source-relative (rho, azimuth_rad, z_closest, residual_t) for infinite
    muon tracks (cylindrical_coordinates.c.cl:42-63); the time residual is
    relative to the geometric Cherenkov cone (l + rho*tan(theta_c))/c.

    `dirp` (optional randomized photon direction) appends the impact-angle
    cosine against the vector from the nominal Cherenkov emission point to
    the impact point (cylindrical_coordinates.c.cl:61-75)."""
    from ..constants import C_LIGHT
    rx = px - source.pos[0]
    ry = py - source.pos[1]
    rz = pz - source.pos[2]
    l = rx * source.dir[0] + ry * source.dir[1] + rz * source.dir[2]
    hx = rx - l * source.dir[0]
    hy = ry - l * source.dir[1]
    hz = rz - l * source.dir[2]
    rho = jnp.sqrt(hx * hx + hy * hy + hz * hz)
    cos_az = (hx * source.perp[0] + hy * source.perp[1] + hz * source.perp[2]) \
        / jnp.maximum(rho, 1e-20)
    azimuth = jnp.where(rho > 0, jnp.arccos(jnp.clip(cos_az, -1.0, 1.0)), 0.0)
    z_closest = source.pos[2] + l * source.dir[2]
    dt = (pt - source.time) - (l + rho * tan_theta_c) / C_LIGHT
    if dirp is None:
        return rho, azimuth, z_closest, dt
    lc = l - rho / tan_theta_c
    cx = rx - lc * source.dir[0]
    cy = ry - lc * source.dir[1]
    cz = rz - lc * source.dir[2]
    cdist = jnp.sqrt(cx * cx + cy * cy + cz * cz)
    cimp = (dirp[0] * cx + dirp[1] * cy + dirp[2] * cz) \
        / jnp.maximum(cdist, 1e-20)
    cimp = jnp.where(cdist > 0, jnp.clip(cimp, -1.0, 1.0), 1.0)
    return rho, azimuth, z_closest, dt, cimp


def _spherical_coords(px, py, pz, pt, source: ReferenceSource,
                      min_inv_groupvel, dirp=None):
    """Source-relative (r, azimuth_deg, cos_polar, residual_t); the azimuth
    is folded to [0, 180] (spherical_coordinates.c.cl:28-66).

    `dirp` (optional randomized photon direction) appends the impact-angle
    cosine against the emitter-to-impact-point vector
    (spherical_coordinates.c.cl:67-75)."""
    rx = px - source.pos[0]
    ry = py - source.pos[1]
    rz = pz - source.pos[2]
    r = jnp.sqrt(rx * rx + ry * ry + rz * rz)
    l = rx * source.dir[0] + ry * source.dir[1] + rz * source.dir[2]
    hx = rx - l * source.dir[0]
    hy = ry - l * source.dir[1]
    hz = rz - l * source.dir[2]
    n_rho = jnp.sqrt(hx * hx + hy * hy + hz * hz)
    cos_az = (hx * source.perp[0] + hy * source.perp[1] + hz * source.perp[2]) \
        / jnp.maximum(n_rho, 1e-20)
    azimuth = jnp.where(n_rho > 0,
                        jnp.arccos(jnp.clip(cos_az, -1.0, 1.0)) / (PI / 180.0),
                        0.0)
    cos_polar = jnp.where(r > 0, l / jnp.maximum(r, 1e-20), 0.0)
    dt = (pt - source.time) - r * min_inv_groupvel
    if dirp is None:
        return r, azimuth, cos_polar, dt
    cimp = (dirp[0] * rx + dirp[1] * ry + dirp[2] * rz) \
        / jnp.maximum(r, 1e-20)
    cimp = jnp.where(r > 0, jnp.clip(cimp, -1.0, 1.0), 1.0)
    return r, azimuth, cos_polar, dt, cimp


def _impact_direction(dx, dy, dz, u_sin, u_az):
    """Photon direction randomized over the receiver's cross-section:
    rotate by asin(sqrt(u)) about a uniform azimuth (the 'average over
    possible DOM positions', spherical_coordinates.c.cl:68-74)."""
    from ..ops.rotations import scatter_direction_by_angle, safe_sqrt
    sina = jnp.sqrt(u_sin)
    cosa = safe_sqrt(1.0 - u_sin)
    return scatter_direction_by_angle(cosa, sina, dx, dy, dz, u_az)


def _make_tabulate_chunk(medium: MediumProperties, spectra: SpectrumTable,
                         source: ReferenceSource, angular_coeffs,
                         cfg: PropagationConfig, axes: SphericalAxes,
                         step_length: float, min_inv_groupvel, tan_theta_c,
                         chunk_iters: int = 16):
    """Build the jitted propagation chunk ONCE per tabulate() run so its
    compilation is reused across step batches (defining the jit inside the
    per-batch function made the cache miss on every batch -- seconds of
    recompile per batch on a remote-compile link).  `steps` and `key` are
    traced arguments; the physics configuration is closed over as
    constants."""
    max_substeps = int(cfg.max_segment_m / step_length) + 2

    from ..medium.functions import eval_polynomial

    def body(k, carry, i0, steps, key):
        state, remainder, idx_buf, w_buf = carry
        n = steps.x.shape[0]
        i = i0 + k
        u = rng.uniforms(rng.iter_key(key, i), (n,), 9)

        fresh = (~state.in_flight) & (state.photons_left > 0)
        state = E._create_photons(state, steps, medium, spectra, cfg, u[:4],
                                  fresh)
        state = state._replace(
            in_flight=state.in_flight | fresh,
            photons_left=state.photons_left - fresh.astype(jnp.int32))
        # randomize the first sub-step offset per new photon (kernel:562)
        remainder = jnp.where(fresh, step_length * (1.0 - u[8]), remainder)

        active = state.in_flight
        abs_corr = abs_len_scaling(medium.anisotropy, state.dx, state.dy,
                                   state.dz)
        sca_budget = -jnp.log(rng.uniform_oc(u[4]))
        abs_budget = state.abs_lens_left * abs_corr
        d_prop, absorbed, scattered, abs_left = E._segment_distances(
            state, medium, cfg, sca_budget, abs_budget)
        abs_left = abs_left / abs_corr

        depth_start = state.abs_lens_initial - state.abs_lens_left
        step_depth = state.abs_lens_left - abs_left

        # with an impact-angle axis the acceptance weight is REPLACED by the
        # explicit dimension (propagation_kernel.c.cl:245-250)
        if getattr(axes, "impact_angle", False):
            impact = steps.weight
        else:
            impact = steps.weight * eval_polynomial(angular_coeffs,
                                                    jnp.clip(state.dz, -1, 1))

        # deposit at substeps remainder, remainder+dl, ... < d_prop
        with_impact = bool(getattr(axes, "impact_angle", False))
        sub_key = rng.iter_key(rng.iter_key(key, i), 0x1A7B)  # impact draws
        new_remainder = remainder
        idx_parts = []
        w_parts = []
        for m in range(max_substeps):
            d = remainder + m * step_length
            in_seg = (d < d_prop) & active
            px = state.x + d * state.dx
            py = state.y + d * state.dy
            pz = state.z + d * state.dz
            pt = state.t + d * state.inv_groupvel
            dirp = None
            if with_impact:
                ui = rng.uniforms(rng.iter_key(sub_key, m), (n,), 2)
                dirp = _impact_direction(state.dx, state.dy, state.dz,
                                         ui[0], ui[1])
            if getattr(axes, "kind", "spherical") == "cylindrical":
                coords = _cylindrical_coords(px, py, pz, pt, source,
                                             min_inv_groupvel, tan_theta_c,
                                             dirp)
            else:
                coords = _spherical_coords(px, py, pz, pt, source,
                                           min_inv_groupvel, dirp)
            oob = axes.out_of_bounds(coords)
            frac = d / jnp.maximum(d_prop, 1e-20)
            w = jnp.where(in_seg & ~oob,
                          impact * jnp.exp(-(depth_start + frac * step_depth)),
                          0.0)
            idx = axes.flat_index(coords)
            idx_parts.append(jnp.clip(idx, 0, axes.n_bins - 1))
            w_parts.append(w)
            # photons that leave the table bounds stop propagating
            state = state._replace(
                in_flight=state.in_flight & ~(in_seg & oob))
            new_remainder = jnp.where(in_seg, d + step_length - d_prop,
                                      new_remainder)
        idx_buf = jax.lax.dynamic_update_index_in_dim(
            idx_buf, jnp.stack(idx_parts).reshape(-1), k, 0)
        w_buf = jax.lax.dynamic_update_index_in_dim(
            w_buf, jnp.stack(w_parts).reshape(-1), k, 0)
        remainder = jnp.where(active, new_remainder, remainder)

        # advance / absorb / scatter (same flow as the main engine)
        state = state._replace(
            x=state.x + jnp.where(active, state.dx * d_prop, 0.0),
            y=state.y + jnp.where(active, state.dy * d_prop, 0.0),
            z=state.z + jnp.where(active, state.dz * d_prop, 0.0),
            t=state.t + jnp.where(active, state.inv_groupvel * d_prop, 0.0),
            total_path=state.total_path + jnp.where(active, d_prop, 0.0),
            abs_lens_left=jnp.where(active, abs_left, state.abs_lens_left))

        do_scatter = scattered & active
        from ..medium.anisotropy import (post_scatter_transform,
                                         pre_scatter_transform)
        from ..ops.rotations import scatter_direction_by_angle, safe_sqrt
        from ..ops.samplers import mixed_cos
        pdx, pdy, pdz = pre_scatter_transform(medium.anisotropy, state.dx,
                                              state.dy, state.dz)
        cos_s = mixed_cos(medium.scattering.mean_cos,
                          medium.scattering.liu_fraction, u[5], u[6])
        sin_s = safe_sqrt(1.0 - cos_s * cos_s)
        sdx, sdy, sdz = scatter_direction_by_angle(cos_s, sin_s, pdx, pdy,
                                                   pdz, u[7])
        sdx, sdy, sdz = post_scatter_transform(medium.anisotropy, sdx, sdy, sdz)
        state = state._replace(
            dx=jnp.where(do_scatter, sdx, state.dx),
            dy=jnp.where(do_scatter, sdy, state.dy),
            dz=jnp.where(do_scatter, sdz, state.dz))

        died = active & (absorbed | (state.abs_lens_left < E.EPSILON))
        state = state._replace(in_flight=state.in_flight & ~died)
        return (state, remainder, idx_buf, w_buf)

    # compaction capacity as a fraction of the raw buffer: the comb is
    # ~55-60% occupied while lanes are alive (d_prop is usually near the
    # segment cap), so a small capacity would overflow every early chunk
    # and fall back to raw -- 2/3 covers the live phase and the drain
    # tail compacts far below it
    compact_num, compact_den = 2, 3

    def run_chunk(steps, key, state, remainder, i0):
        K = chunk_iters
        n = steps.x.shape[0]
        idx_buf = jnp.zeros((K, max_substeps * n), jnp.int32)
        w_buf = jnp.zeros((K, max_substeps * n), jnp.float32)
        state, remainder, idx_buf, w_buf = jax.lax.fori_loop(
            0, K, lambda k, c: body(k, c, i0, steps, key),
            (state, remainder, idx_buf, w_buf))
        alive = jnp.sum((state.in_flight
                         | (state.photons_left > 0)).astype(jnp.int32))
        return state, remainder, idx_buf, w_buf, alive

    @jax.jit
    def chunk_raw(steps, key, state, remainder, i0):
        return run_chunk(steps, key, state, remainder, i0)

    @jax.jit
    def chunk_compact(steps, key, state, remainder, i0):
        """Raw chunk + ON-DEVICE nonzero compaction of the deposit comb
        (round-4 review item 8): the raw (bin, weight) buffer is
        ~(1 - occupancy) zeros -- dead lanes, unused substeps, oob
        photons -- and shipping it uncompacted is what made the
        device->host link bind.  Returns the H densest entries plus the
        true nonzero count; the host falls back to the raw chunk (same
        inputs => identical stream) in the rare overflow case."""
        n = steps.x.shape[0]
        H = (chunk_iters * max_substeps * n * compact_num) // compact_den
        state, remainder, idx_buf, w_buf, alive = run_chunk(
            steps, key, state, remainder, i0)
        fw = w_buf.reshape(-1)
        fi = idx_buf.reshape(-1)
        nz = fw != 0.0
        n_nz = jnp.sum(nz.astype(jnp.int32))
        sel = jnp.nonzero(nz, size=H, fill_value=0)[0]
        w_c = jnp.where(jnp.arange(H) < n_nz, fw[sel], 0.0)
        i_c = fi[sel]
        return state, remainder, i_c, w_c, n_nz, alive

    chunk_compact.raw = chunk_raw
    return chunk_compact


def _tabulate_batch(chunk, steps: StepBatch, key, axes: SphericalAxes,
                    chunk_iters: int = 16):
    """Propagate one slot-assigned batch in table mode and return the raw
    (unnormalized) flat bin contents.

    Deposit strategy: the device runs the propagation in jitted chunks
    (prebuilt by _make_tabulate_chunk) that OUTPUT the comb's (bin, weight)
    entries, and the host accumulates them into the ~1M-bin table with
    np.add.at.  Whether a device-side scatter-add into the table is faster
    is not measured yet (scripts/bench_tabulator.py times this path)."""
    n = steps.x.shape[0]
    state = E._init_state(steps)
    content = np.zeros(axes.n_bins, np.float64)
    remainder = jnp.zeros(n, jnp.float32)
    i0 = 0
    for _ in range(65536 // chunk_iters):
        st2, rem2, i_c, w_c, n_nz, alive = chunk(
            steps, key, state, remainder, jnp.int32(i0))
        if int(n_nz) > w_c.shape[0]:
            # compaction capacity exceeded (dense comb): re-run the SAME
            # chunk raw -- identical inputs give the identical stream
            _, _, idx_buf, w_buf, _ = chunk.raw(
                steps, key, state, remainder, jnp.int32(i0))
            wn = np.asarray(w_buf, np.float64).ravel()
            nzm = wn != 0.0
            if nzm.any():
                np.add.at(content, np.asarray(idx_buf).ravel()[nzm],
                          wn[nzm])
        else:
            wn = np.asarray(w_c, np.float64)
            nzm = wn != 0.0
            if nzm.any():
                np.add.at(content, np.asarray(i_c)[nzm], wn[nzm])
        state, remainder = st2, rem2
        i0 += chunk_iters
        if int(alive) == 0:
            break
    return jnp.asarray(content, jnp.float32)


class PhotonTable(NamedTuple):
    values: np.ndarray        # normalized contents, shape axes.shape
    weights_sq: Optional[np.ndarray]
    axes: object
    n_photons: float
    header: dict


def tabulate(step_batches, medium: MediumProperties, spectra: SpectrumTable,
             source: ReferenceSource, seed: int,
             axes: Optional[SphericalAxes] = None,
             angular_coeffs=None,
             cfg: Optional[PropagationConfig] = None,
             step_length: float = 1.0,
             abs_lens_horizon: float = 46.0,
             dom_radius: float = 0.16510) -> PhotonTable:
    """Generate a photon table from slot-assigned step batches (the
    TabulatePhotonsFromSource equivalent, python/tablemaker/tabulator.py:441)."""
    from .axes import default_spherical_axes
    from ..hits.acceptance import dom_angular_sensitivity

    axes = axes or default_spherical_axes()
    if angular_coeffs is None:
        angular_coeffs = dom_angular_sensitivity()
    cfg = cfg or PropagationConfig(n_slots=int(step_batches[0].x.shape[0]))
    import dataclasses as dc
    cfg = dc.replace(cfg, fixed_abs_lens=abs_lens_horizon,
                     stop_on_detection=False)

    # GetMinimumRefractiveIndex (I3CLSimStepToTableConverter.cxx:191-196):
    # minimum group index sets min_invGroupVel; the phase index at that
    # wavelength sets tan(theta_c) for the cylindrical time residual
    wl = np.linspace(medium.min_wlen, medium.max_wlen, 128)
    n_group = np.asarray(jax.vmap(medium.group_ref_index)(
        jnp.asarray(wl, jnp.float32)))
    n_phase = np.asarray(jax.vmap(medium.phase_ref_index)(
        jnp.asarray(wl, jnp.float32)))
    i_min = int(np.argmin(n_group))
    from ..constants import C_LIGHT
    min_inv_gv = float(n_group[i_min] / C_LIGHT)
    tan_theta_c = float(np.sqrt(n_phase[i_min] ** 2 - 1.0))

    key = jax.random.PRNGKey(seed)
    total = np.zeros(axes.n_bins, np.float64)
    n_photons = 0.0
    chunk = _make_tabulate_chunk(medium, spectra, source, angular_coeffs,
                                 cfg, axes, float(step_length),
                                 jnp.float32(min_inv_gv),
                                 jnp.float32(tan_theta_c))
    for i, batch in enumerate(step_batches):
        b = StepBatch(*[jnp.asarray(f) for f in batch])
        content = _tabulate_batch(chunk, b, jax.random.fold_in(key, i), axes)
        total += np.asarray(content, np.float64)
        n_photons += float(np.asarray(batch.num_photons).sum())

    # normalize spatial cells: content /= bin_volume/(step_length*dom_area)
    values = total.reshape(axes.shape)
    vol = axes.bin_volumes()  # (nr, naz, nct) for the inner data bins
    dom_area = PI * dom_radius ** 2
    # only the first 3 dims are spatial; the time (and optional impact-angle)
    # dims share each spatial cell's norm (I3CLSimStepToTableConverter
    # .cxx:513-540 Normalize)
    norm = np.ones(axes.shape[:3])
    norm[1:-1, 1:-1, 1:-1] = vol / (step_length * dom_area)
    values = values / norm.reshape(norm.shape + (1,) * (values.ndim - 3))

    header = dict(n_photons=n_photons, step_length=step_length,
                  abs_lens_horizon=abs_lens_horizon, dom_radius=dom_radius,
                  seed=seed, n_group=n_group[i_min], n_phase=n_phase[i_min])
    return PhotonTable(values=values, weights_sq=None, axes=axes,
                       n_photons=n_photons, header=header)


def save_table_npz(table: PhotonTable, path: str):
    """Persist a photon table (.npz with values, bin edges and header --
    the FITS writer analog, I3CLSimStepToTableConverter.cxx:593-686)."""
    np.savez_compressed(
        path, values=table.values,
        **{f"edges_{i}": a.bin_edges() for i, a in enumerate(table.axes.axes)},
        **{f"header_{k}": v for k, v in table.header.items()})
