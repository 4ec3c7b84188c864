"""The photon propagation engine: the one propagation path, in plain JAX.

A vectorized redesign of the reference's device kernel
(resources/kernels/propagation_kernel.c.cl:406-913 and
sparse_collision_kernel.c.cl).  The physics contract is identical; the
execution model is not a port:

  * one *photon slot* per vector lane instead of one OpenCL work item per
    step; slots regenerate a fresh photon from their assigned step the moment
    the previous one dies, keeping lanes full (the reference hides photon
    lifetime variance in SIMT while-loops; we hide it in slot recycling),
  * propagation segments are capped at `max_segment_m`.  Because exponential
    scatter distances are memoryless, truncating a segment at the cap and
    re-sampling a fresh scattering depth next iteration is *statistically
    identical* to the reference's unbounded segments -- and it bounds the
    per-iteration medium-layer and DOM-layer windows to static trip counts,
    which is what makes the whole loop compile to branchless vector code,
  * the layered-ice optical-depth -> meters conversion walks layers with a
    fixed-bound masked loop (same piecewise-constant integral as
    propagation_kernel.c.cl:646-676, so results agree to float precision),
  * DOM collision uses a dense all-strings 2-D cull + top-K nearest-string
    selection + per-string DOM slot table instead of the 2-D cell grid
    (see geometry.py),
  * hits are deposited into per-DOM time histograms via scatter-add
    (replacing the reference's atomic hit-append,
    propagation_kernel.c.cl:329), with an optional fixed-capacity photon
    record ring per slot for I3Photon-level parity output,
  * randomness is counter-based threefry keyed on (iteration), so samplers
    are reparameterized and the whole estimator differentiates w.r.t. the
    medium parameters.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..constants import C_LIGHT
from ..geometry import EMPTY, DetectorGeometry
from ..medium.anisotropy import (abs_len_scaling, post_scatter_transform,
                                 pre_scatter_transform)
from ..medium.properties import MediumProperties
from ..medium.tilt import tilt_z_shift
from ..ops import rng
from ..ops.lookup import (compact_scatter_add, masked_set, onehot_gather,
                          ring_write, select_rows_exact,
                          shifted_window_table)
from ..ops.rotations import (cart_to_sph, safe_sqrt,
                             scatter_direction_by_angle)
from ..ops.samplers import (mixed_cos, rayleigh_cos,
                            sample_interpolated_fast)
from ..ops.spectrum import (SpectrumTable, sample_wavelength_dispatch,
                            wavelength_bias)
from ..types import PhotonBatch, PropagationConfig, StepBatch

EPSILON = 1e-5  # matches the reference kernel's single-precision EPSILON
BIG = 1e30


class SlotState(NamedTuple):
    """Per-slot propagation state; every field has shape (N,)."""
    photons_left: jnp.ndarray   # photons this slot still has to spawn
    in_flight: jnp.ndarray      # bool: a live photon occupies the slot
    # live photon
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray
    t: jnp.ndarray
    dx: jnp.ndarray
    dy: jnp.ndarray
    dz: jnp.ndarray
    wlen: jnp.ndarray
    inv_groupvel: jnp.ndarray
    abs_lens_left: jnp.ndarray
    abs_lens_initial: jnp.ndarray
    num_scatters: jnp.ndarray
    total_path: jnp.ndarray
    # emission record (for photon output)
    start_x: jnp.ndarray
    start_y: jnp.ndarray
    start_z: jnp.ndarray
    start_t: jnp.ndarray
    start_dx: jnp.ndarray
    start_dy: jnp.ndarray
    start_dz: jnp.ndarray
    # optional per-photon scatter history rings, each (N, H)
    # (I3CLSimPhotonHistory / SAVE_PHOTON_HISTORY,
    #  propagation_kernel.c.cl:452-455, 833-837)
    hist_x: Optional[jnp.ndarray] = None
    hist_y: Optional[jnp.ndarray] = None
    hist_z: Optional[jnp.ndarray] = None
    hist_abs: Optional[jnp.ndarray] = None
    # running log-likelihood of the photon's sampled scatter events
    # (cfg.score_function; None otherwise) -- see types.PropagationConfig
    log_lik: Optional[jnp.ndarray] = None


class Accumulators(NamedTuple):
    hist: jnp.ndarray              # (n_doms * n_bins,) weighted hits
    n_generated: jnp.ndarray       # () photons spawned
    n_hits: jnp.ndarray            # () photons recorded at DOMs
    weight_hits: jnp.ndarray       # () sum of recorded weights
    # optional photon record ring buffers, (N, K) each; None if disabled
    rec_count: Optional[jnp.ndarray]
    rec: Optional[dict]


class PropagationResult(NamedTuple):
    hist: jnp.ndarray              # (n_doms, n_bins)
    n_generated: jnp.ndarray
    n_hits: jnp.ndarray
    weight_hits: jnp.ndarray
    n_iterations: jnp.ndarray
    rec_count: Optional[jnp.ndarray] = None
    rec: Optional[dict] = None


# ---------------------------------------------------------------------------
# photon creation (createPhotonFromTrack, propagation_kernel.c.cl:132-184)
# ---------------------------------------------------------------------------

def _create_photons(state: SlotState, steps: StepBatch,
                    medium: MediumProperties, spectra: SpectrumTable,
                    cfg: PropagationConfig, u, fresh):
    """Spawn a new photon from each slot's step where `fresh` is set."""
    u_shift, u_wlen, u_azi, u_abs = u[0], u[1], u[2], u[3]

    shift = steps.length * u_shift
    px = steps.x + steps.dir_x * shift
    py = steps.y + steps.dir_y * shift
    pz = steps.z + steps.dir_z * shift
    # time advance at the particle's speed (c * beta)
    pt = steps.t + shift / (C_LIGHT * steps.beta)

    wlen = sample_wavelength_dispatch(spectra, steps.source_type, u_wlen)

    n_phase = medium.phase_ref_index(wlen)
    cos_c = jnp.minimum(1.0, 1.0 / (steps.beta * n_phase))
    sin_c = safe_sqrt(1.0 - cos_c * cos_c)
    cdx, cdy, cdz = scatter_direction_by_angle(
        cos_c, sin_c, steps.dir_x, steps.dir_y, steps.dir_z, u_azi)
    # flasher sources (source_type >= 1) keep the step direction untouched
    is_cherenkov = steps.source_type == 0
    ndx = jnp.where(is_cherenkov, cdx, steps.dir_x)
    ndy = jnp.where(is_cherenkov, cdy, steps.dir_y)
    ndz = jnp.where(is_cherenkov, cdz, steps.dir_z)

    inv_gv = 1.0 / medium.group_velocity(wlen)

    if cfg.estimator == "expected" or cfg.fixed_abs_lens > 0.0:
        # fixed horizon (the tabulator's PROPAGATE_FOR_FIXED_NUMBER_OF_
        # ABSORPTION_LENGTHS; default matches photonics' 1e-20 survival)
        horizon = cfg.fixed_abs_lens if cfg.fixed_abs_lens > 0.0 else 46.0
        abs_init = jnp.full_like(px, horizon)
    else:
        abs_init = -jnp.log(rng.uniform_oc(u_abs))

    sel = lambda new, old: jnp.where(fresh, new, old)
    return state._replace(
        x=sel(px, state.x), y=sel(py, state.y), z=sel(pz, state.z),
        t=sel(pt, state.t),
        dx=sel(ndx, state.dx), dy=sel(ndy, state.dy), dz=sel(ndz, state.dz),
        wlen=sel(wlen, state.wlen),
        inv_groupvel=sel(inv_gv, state.inv_groupvel),
        abs_lens_left=sel(abs_init, state.abs_lens_left),
        abs_lens_initial=sel(abs_init, state.abs_lens_initial),
        num_scatters=sel(jnp.zeros_like(state.num_scatters), state.num_scatters),
        total_path=sel(jnp.zeros_like(state.total_path), state.total_path),
        start_x=sel(px, state.start_x), start_y=sel(py, state.start_y),
        start_z=sel(pz, state.start_z), start_t=sel(pt, state.start_t),
        start_dx=sel(ndx, state.start_dx), start_dy=sel(ndy, state.start_dy),
        start_dz=sel(ndz, state.start_dz),
    )


# ---------------------------------------------------------------------------
# layered-ice optical depth walk (propagation_kernel.c.cl:598-696)
# ---------------------------------------------------------------------------

def _segment_distances(state: SlotState, medium: MediumProperties,
                       cfg: PropagationConfig, sca_budget, abs_budget,
                       with_score: bool = False):
    """Convert the scattering budget (in scattering lengths) and absorption
    budget (in absorption lengths, anisotropy-corrected) to meters through
    the layered medium, both capped at cfg.max_segment_m.

    Returns (d_prop, absorbed, scattered, abs_left_after) where d_prop is the
    geometric distance this segment will cover *before* collision limiting,
    and abs_left_after is the remaining absorption budget if the photon
    travels the full d_prop.

    with_score additionally returns (tau_s_traced, inv_s_fin, t_done): the
    ingredients of the segment's scattering log-likelihood for the
    score-function estimator (types.PropagationConfig.score_function) --
    tau_s_traced is the optical SCATTERING depth over the completed layer
    crossings with TRACED coefficients but stop-gradiented layer lengths,
    inv_s_fin the (traced) scattering coefficient of the final layer, and
    t_done the detachable distance already covered by complete crossings.
    """
    T = medium.layer_height
    L = medium.n_layers

    shift = tilt_z_shift(medium.tilt, state.x, state.y, state.z)
    z_eff = state.z - shift
    j0 = medium.layer_for_z(z_eff)

    gs = medium.scat_coeff(state.wlen)
    pa, qa, ra = medium.abs_coeffs(state.wlen)

    dz = state.dz
    going_up = dz >= 0.0
    dirsign = jnp.where(going_up, 1, -1).astype(jnp.int32)
    abs_dz = jnp.abs(dz)
    vertical = abs_dz < EPSILON

    boundary_z = medium.layer_bottom_z(j0) + jnp.where(going_up, T, 0.0)
    # safe denominator: a bare /dz at dz==0 creates inf in the discarded
    # where-branch, which becomes 0*inf = NaN in the backward pass
    safe_dz = jnp.where(vertical, 1.0, dz)
    t_bound0 = jnp.where(vertical, BIG, (boundary_z - z_eff) / safe_dz)
    # guard: photons outside the layer grid can get a negative first boundary
    # distance; the reference's walk never runs in that situation either
    t_bound0 = jnp.where(t_bound0 < 0.0, BIG, t_bound0)
    t_step = jnp.where(vertical, BIG, T / jnp.maximum(abs_dz, 1e-20))

    # fetch each photon's whole +-K layer neighborhood in one lookup and
    # index the walk steps with static slices
    K = cfg.max_layer_steps
    Wb = shifted_window_table(medium.b400, K)        # (L, 2K+1)
    Wa = shifted_window_table(medium.a_dust400, K)
    Wt = shifted_window_table(medium.delta_tau, K)
    win = onehot_gather(jnp.concatenate([Wb, Wa, Wt], axis=1), j0)
    w_width = 2 * K + 1
    winb = win[:, :w_width]
    wina = win[:, w_width:2 * w_width]
    wint = win[:, 2 * w_width:]

    def layer_vals(k):
        """(inv_s, inv_a) of layer j0 + k*dirsign (edge-clamped by table).
        k is a static python int, so all slicing is static."""
        b = jnp.where(going_up, winb[:, K + k], winb[:, K - k])
        a = jnp.where(going_up, wina[:, K + k], wina[:, K - k])
        dt_ = jnp.where(going_up, wint[:, K + k], wint[:, K - k])
        return gs * b, pa * a + qa + ra * dt_

    n = state.x.shape[0]
    zeros = jnp.zeros(n, state.x.dtype)

    # statically unrolled walk (K+1 <= ~17 steps of pure vector math)
    t_done, t_bound = zeros, t_bound0
    tau_s, tau_a = sca_budget, abs_budget
    done = jnp.zeros(n, bool)
    d_scat, d_abs = zeros, zeros
    inv_a = jnp.ones(n, state.x.dtype)
    sg = jax.lax.stop_gradient
    tau_s_traced = zeros
    inv_s_fin = jnp.ones(n, state.x.dtype)
    for k in range(K + 1):
        inv_s_k, inv_a_k = layer_vals(k)
        d_s = t_done + tau_s / inv_s_k
        d_a = t_done + tau_a / inv_a_k
        # stop walking at the extreme layers (the reference extends them to
        # infinity) or when either budget exhausts before the boundary,
        # or once past the segment cap
        cur_j = j0 + k * dirsign
        at_edge = jnp.where(going_up, cur_j >= L - 1, cur_j <= 0)
        exhaust = t_bound >= jnp.minimum(d_s, d_a)
        past_cap = t_bound >= cfg.max_segment_m
        cross = (~done) & (~at_edge) & (~exhaust) & (~past_cap)
        finalize = (~done) & (~cross)

        d_scat = jnp.where(finalize, d_s, d_scat)
        d_abs = jnp.where(finalize, d_a, d_abs)
        inv_a = jnp.where(finalize, inv_a_k, inv_a)
        if with_score:
            inv_s_fin = jnp.where(finalize, inv_s_k, inv_s_fin)

        dt = t_bound - t_done
        tau_s = jnp.where(cross, tau_s - dt * inv_s_k, tau_s)
        tau_a = jnp.where(cross, tau_a - dt * inv_a_k, tau_a)
        if with_score:
            tau_s_traced = jnp.where(cross, tau_s_traced + sg(dt) * inv_s_k,
                                     tau_s_traced)
        t_done = jnp.where(cross, t_bound, t_done)
        t_bound = jnp.where(cross, t_bound + t_step, t_bound)
        done = done | finalize
    # lanes that crossed K times without finalizing: close them with the
    # outermost window column (only reachable when the cap exceeds what K
    # layers can span, which the default configuration excludes)
    inv_s_last, inv_a_last = layer_vals(K)
    d_scat = jnp.where(done, d_scat, t_done + tau_s / inv_s_last)
    d_abs = jnp.where(done, d_abs, t_done + tau_a / inv_a_last)
    inv_a = jnp.where(done, inv_a, inv_a_last)
    if with_score:
        inv_s_fin = jnp.where(done, inv_s_fin, inv_s_last)

    absorbed = d_abs < d_scat
    d_prop = jnp.minimum(jnp.minimum(d_scat, d_abs), cfg.max_segment_m)
    capped = (~absorbed & (d_scat > cfg.max_segment_m)) | \
             (absorbed & (d_abs > cfg.max_segment_m))
    absorbed = absorbed & ~capped
    scattered = (~absorbed) & (~capped)

    # score mode: the sampled segment length is part of the trajectory law,
    # whose theta-sensitivity the score term carries -- letting the TRACED
    # d_prop (through d_scat) also flow into the absorption bookkeeping
    # would double-count it (measured: a +29.5k spurious pathwise term vs
    # the -105k FD truth on the beam workload).  Detach the geometry here;
    # the absorption-parameter channels stay traced via tau_a / inv_a, and
    # absorbed lanes are zeroed below regardless.
    d_for_abs = sg(d_prop) if with_score else d_prop
    abs_left_after = jnp.maximum(tau_a - (d_for_abs - t_done) * inv_a, 0.0)
    abs_left_after = jnp.where(absorbed, 0.0, abs_left_after)
    if with_score:
        return (d_prop, absorbed, scattered, abs_left_after,
                (tau_s_traced, inv_s_fin, t_done))
    return d_prop, absorbed, scattered, abs_left_after


# ---------------------------------------------------------------------------
# collision detection (sparse_collision_kernel.c.cl)
# ---------------------------------------------------------------------------

def _check_collisions_bruteforce(state: SlotState, geo: DetectorGeometry,
                                 cfg: PropagationConfig, d_prop, active):
    """O(N x D) exact sphere test against every DOM -- the validation oracle
    for the culled path and the right choice for small test geometries."""
    x, y, z = state.x, state.y, state.z
    dx, dy, dz = state.dx, state.dy, state.dz
    R = geo.collision_radius
    ox = geo.dom_x[None, :] - x[:, None]
    oy = geo.dom_y[None, :] - y[:, None]
    oz = geo.dom_z[None, :] - z[:, None]
    dr2 = ox * ox + oy * oy + oz * oz
    urdot = ox * dx[:, None] + oy * dy[:, None] + oz * dz[:, None]
    discr = urdot * urdot - dr2 + R * R
    sq = safe_sqrt(discr) / cfg.pancake_factor
    smin1 = urdot - sq
    has_xy = (dx * dx + dy * dy) > 0.0
    good = (discr >= 0.0) & (urdot + sq >= 0.0) & (smin1 >= 0.0) \
         & (smin1 < d_prop[:, None]) & active[:, None] & has_xy[:, None]
    smin1 = jnp.where(good, smin1, BIG)
    hit_dom = jnp.argmin(smin1, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(smin1, hit_dom[:, None], 1)[:, 0]
    hit = best < BIG
    hit_dist = jnp.where(hit, best, d_prop)
    return hit, hit_dist, hit_dom


def _check_collisions(state: SlotState, geo: DetectorGeometry,
                      cfg: PropagationConfig, d_prop, active):
    """Find the closest DOM intersection within d_prop along the ray.

    Two-level test replacing the reference's cell-grid/z-layer walk
    (sparse_collision_kernel.c.cl): (1) dense 2-D cull + z cull over all
    strings -- pure vector math; (2) for the top-K nearest candidate strings,
    fetch the string's full dense DOM slot table and sphere-test every slot.

    Returns (hit, hit_dist, hit_dom): hit_dist <= d_prop is the entry-point
    distance smin1 (sparse_collision_kernel.c.cl:109-158), hit_dom the flat
    DOM index."""
    x, y, z = state.x, state.y, state.z
    dx, dy, dz = state.dx, state.dy, state.dz
    n = x.shape[0]
    R = geo.collision_radius
    R2 = R * R
    pancake = cfg.pancake_factor

    dir_xy2 = dx * dx + dy * dy
    has_xy = dir_xy2 > 0.0
    inv_dir_xy2 = 1.0 / jnp.maximum(dir_xy2, 1e-20)

    # ---- 2D string cull + ranking (dense over all strings) ----
    sx = geo.string_x[None, :]   # (1, S)
    sy = geo.string_y[None, :]
    rx = sx - x[:, None]         # (N, S)
    ry = sy - y[:, None]
    # closest approach parameter of the infinite 2D ray, clamped to the
    # STATIC segment cap (not this segment's d_prop): candidates beyond
    # d_prop are rejected by the sphere test's distance gate, and the
    # constant cap keeps the cull independent of the layer walk)
    t2d = jnp.clip((rx * dx[:, None] + ry * dy[:, None]) * inv_dir_xy2[:, None],
                   0.0, cfg.max_segment_m)
    cx = x[:, None] + dx[:, None] * t2d - sx
    cy = y[:, None] + dy[:, None] * t2d - sy
    dist2 = cx * cx + cy * cy

    pass_r = dist2 <= (geo.string_max_r[None, :] ** 2)
    # z cull (…OnString, sparse_collision_kernel.c.cl:67-70)
    pass_z = ~((dz[:, None] > 0) & (z[:, None] > geo.string_max_z[None, :] + R)) \
           & ~((dz[:, None] < 0) & (z[:, None] < geo.string_min_z[None, :] - R))
    candidate = pass_r & pass_z & has_xy[:, None] & active[:, None]

    ranked = jnp.where(candidate, dist2, BIG)

    hit_found = jnp.zeros(n, bool)
    hit_dist = d_prop
    hit_dom = jnp.zeros(n, jnp.int32)

    S, M, _ = geo.string_dom_rel.shape
    rel_table = geo.string_dom_rel.reshape(S, M * 4)
    slot_iota = jax.lax.broadcasted_iota(jnp.float32, (n, M), 1)

    for _k in range(cfg.strings_per_photon):
        s_idx = jnp.argmin(ranked, axis=1).astype(jnp.int32)       # (N,)
        s_ok = jnp.min(ranked, axis=1) < BIG
        ranked = masked_set(ranked, s_idx, BIG)

        # position reconstruction: exact per-string frame (only the 5
        # features the sphere test needs) + small per-DOM residuals
        feats = select_rows_exact(geo.string_features[:, (0, 1, 4, 5, 6)],
                                  s_idx)                           # (N, 5)
        rel = onehot_gather(rel_table, s_idx).reshape(n, M, 4)
        dom_xx = feats[:, 0:1] + rel[:, :, 0]
        dom_yy = feats[:, 1:2] + rel[:, :, 1]
        dom_zz = feats[:, 2:3] + feats[:, 3:4] * slot_iota + rel[:, :, 2]
        slot_dom = feats[:, 4:5] + slot_iota                        # flat idx
        ox = dom_xx - x[:, None]
        oy = dom_yy - y[:, None]
        oz = dom_zz - z[:, None]
        valid = (rel[:, :, 3] > 0.5) & s_ok[:, None]

        dr2 = ox * ox + oy * oy + oz * oz
        urdot = ox * dx[:, None] + oy * dy[:, None] + oz * dz[:, None]
        discr = urdot * urdot - dr2 + R2
        sq = safe_sqrt(discr) / pancake
        smin1 = urdot - sq
        smin2 = urdot + sq
        good = valid & (discr >= 0.0) & (smin2 >= 0.0) & (smin1 >= 0.0) \
             & (smin1 < hit_dist[:, None])
        sm = jnp.where(good, smin1, BIG)
        best = jnp.min(sm, axis=1)
        jm = jnp.argmin(sm, axis=1)
        # dom id of the winner without a per-lane row gather
        cols = jax.lax.broadcasted_iota(jnp.int32, sm.shape, 1)
        dom_best = jnp.sum(jnp.where(cols == jm[:, None], slot_dom, 0.0), axis=1)

        found = best < BIG
        hit_found = hit_found | found
        hit_dom = jnp.where(found, dom_best.astype(jnp.int32), hit_dom)
        hit_dist = jnp.where(found, best, hit_dist)

    return hit_found, hit_dist, hit_dom


# ---------------------------------------------------------------------------
# one propagation loop iteration
# ---------------------------------------------------------------------------

def _iteration(i, state: SlotState, acc: Accumulators, steps: StepBatch,
               medium: MediumProperties, geo: DetectorGeometry,
               spectra: SpectrumTable, cfg: PropagationConfig, key):
    n = state.x.shape[0]
    u = rng.uniforms(rng.iter_key(key, i), (n,), 8)

    # --- spawn new photons into empty slots ---
    fresh = (~state.in_flight) & (state.photons_left > 0)
    state = _create_photons(state, steps, medium, spectra, cfg, u[:4], fresh)
    if cfg.photon_history_entries > 0:
        # a fresh photon starts with an empty scatter history
        clr = lambda r: jnp.where(fresh[:, None], 0.0, r)
        state = state._replace(hist_x=clr(state.hist_x),
                               hist_y=clr(state.hist_y),
                               hist_z=clr(state.hist_z),
                               hist_abs=clr(state.hist_abs))
    use_score = (cfg.score_function and cfg.estimator == "expected"
                 and cfg.detach_trajectories)
    if use_score:
        # fresh photons start with an empty sampled-event log-likelihood
        state = state._replace(
            log_lik=jnp.where(fresh, 0.0, state.log_lik))
    state = state._replace(
        in_flight=state.in_flight | fresh,
        photons_left=state.photons_left - fresh.astype(state.photons_left.dtype))
    acc = acc._replace(n_generated=acc.n_generated + jnp.sum(fresh))

    active = state.in_flight

    # --- anisotropy correction in/out (propagation_kernel.c.cl:615-694) ---
    abs_corr = abs_len_scaling(medium.anisotropy, state.dx, state.dy, state.dz)
    sca_budget = -jnp.log(rng.uniform_oc(u[4]))
    abs_budget = state.abs_lens_left * abs_corr

    score_info = None
    if use_score:
        d_prop, absorbed, scattered, abs_left, score_info = \
            _segment_distances(state, medium, cfg, sca_budget, abs_budget,
                               with_score=True)
    else:
        d_prop, absorbed, scattered, abs_left = _segment_distances(
            state, medium, cfg, sca_budget, abs_budget)
    if use_score:
        # segment scattering log-likelihood ingredients: traced coefficients
        # x detached geometry (see types.PropagationConfig.score_function)
        sg = jax.lax.stop_gradient
        tau_acc, inv_s_fin, t_done_w = score_info
        tau_seg_s = tau_acc + jnp.maximum(
            sg(jnp.minimum(d_prop, cfg.max_segment_m) - t_done_w),
            0.0) * inv_s_fin
    if cfg.estimator == "expected" and cfg.detach_trajectories:
        # detached sampling (see types.PropagationConfig.detach_trajectories):
        # the path geometry is treated as a fixed sample; gradients flow
        # through the optical-depth weights, not through chaotic positions
        d_prop = jax.lax.stop_gradient(d_prop)

    # --- collisions ---
    if cfg.collision_mode == "bruteforce":
        hit, hit_dist, hit_dom = _check_collisions_bruteforce(
            state, geo, cfg, d_prop, active)
    else:
        hit, hit_dist, hit_dom = _check_collisions(state, geo, cfg, d_prop, active)

    # consumed absorption budget this segment (uncorrected units), needed by
    # the expected-value estimator before any detect-mode zeroing below
    tau_seg = state.abs_lens_left - abs_left / abs_corr
    tau_start = state.abs_lens_initial - state.abs_lens_left

    stop_on_hit = cfg.stop_on_detection and cfg.estimator == "detect"
    if stop_on_hit:
        d_prop = jnp.where(hit, hit_dist, d_prop)
        absorbed = jnp.where(hit, False, absorbed)
        scattered = jnp.where(hit, False, scattered)
        abs_left = jnp.where(hit, 0.0, abs_left)

    abs_left = abs_left / abs_corr

    # --- record hits ---
    step_weight = steps.weight
    from ..ops.lookup import interp_onehot
    bias = interp_onehot(state.wlen, spectra.bias_x, spectra.bias_y)
    w_hit = jnp.where(hit & active, step_weight / jnp.maximum(bias, 1e-20), 0.0)
    if cfg.estimator == "expected":
        # continuous-absorption estimator: instead of killing the photon at a
        # sampled absorption point, every DOM entry deposits the survival
        # probability exp(-optical depth), linearly interpolated within the
        # segment exactly like the reference's tabulator weighting
        # (propagation_kernel.c.cl:289-290); photons pass through DOMs and
        # die only at the fixed absorption-length horizon.  This is the
        # differentiable path: the weight is smooth in the ice parameters.
        # where-guarded division: max(d_prop, eps) leaves 1/eps^2 = inf in
        # the tangent of dead lanes (d_prop == 0), which turns into NaN
        # under full-pathwise AD (detach_trajectories=False)
        has_dp = d_prop > 0.0
        frac = jnp.where(has_dp,
                         hit_dist / jnp.where(has_dp, d_prop, 1.0), 0.0)
        w_hit = w_hit * jnp.exp(-(tau_start + frac * tau_seg))
        if use_score:
            # likelihood-ratio factor exp(L - sg L) == 1 in the primal; its
            # gradient is the score of every sampled event up to this
            # deposit (completed segments + the no-scatter survival to the
            # DOM within this one)
            L_dep = state.log_lik - jax.lax.stop_gradient(frac) * tau_seg_s
            w_hit = w_hit * jnp.exp(L_dep - jax.lax.stop_gradient(L_dep))
        if cfg.expected_angular_poly is not None:
            # fold the per-photon angular acceptance here, where the
            # direction is known (the accept/reject path applies the same
            # polynomial per record, I3PhotonToMCPEConverter.cxx:466-475)
            ax, ay, az = cfg.pmt_axis
            cos_eta = jnp.clip(-(state.dx * ax + state.dy * ay
                                 + state.dz * az), -1.0, 1.0)
            ang = jnp.zeros_like(cos_eta)
            for c in reversed(cfg.expected_angular_poly):
                ang = ang * cos_eta + c
            w_hit = w_hit * jnp.maximum(ang, 0.0)

    t_hit = state.t + state.inv_groupvel * hit_dist
    tbin_f = (t_hit - cfg.hist_t_min) / cfg.hist_dt
    tbin = jnp.clip(tbin_f.astype(jnp.int32), 0, cfg.hist_n_bins - 1)
    flat_idx = hit_dom * cfg.hist_n_bins + tbin
    cap = cfg.hit_compact_capacity
    if cfg.soft_binning:
        frac_hi = jnp.clip(tbin_f - jnp.floor(tbin_f), 0.0, 1.0)
        tbin_lo = jnp.clip(jnp.floor(tbin_f).astype(jnp.int32), 0, cfg.hist_n_bins - 1)
        tbin_hi = jnp.clip(tbin_lo + 1, 0, cfg.hist_n_bins - 1)
        hist = compact_scatter_add(acc.hist, hit_dom * cfg.hist_n_bins + tbin_lo,
                                   w_hit * (1.0 - frac_hi), cap)
        hist = compact_scatter_add(hist, hit_dom * cfg.hist_n_bins + tbin_hi,
                                   w_hit * frac_hi, cap)
    else:
        hist = compact_scatter_add(acc.hist, flat_idx, w_hit, cap)
    acc = acc._replace(
        hist=hist,
        n_hits=acc.n_hits + jnp.sum((hit & active).astype(jnp.float32)),
        weight_hits=acc.weight_hits + jnp.sum(w_hit))

    # --- optional I3Photon-parity record rings ---
    if cfg.save_photons:
        if cfg.save_all_photons:
            # SAVE_ALL_PHOTONS: record each photon at its absorption point
            # with an optional prescale (propagation_kernel.c.cl:800-826);
            # collision results are ignored in this mode
            rec_mask = active & absorbed
            if cfg.save_all_prescale < 1.0:
                rec_mask = rec_mask & (u[7] < cfg.save_all_prescale)
            hit_dist = d_prop
            hit_dom = jnp.zeros_like(hit_dom)
        else:
            rec_mask = hit & active
        slot_pos = acc.rec_count % cfg.photon_capacity_per_slot
        ddx = geo.dom_x[hit_dom]
        ddy = geo.dom_y[hit_dom]
        ddz = geo.dom_z[hit_dom]
        # undo pancaking: shift the DOM center toward the closest-approach
        # plane (propagation_kernel.c.cl:340-355)
        if cfg.pancake_factor != 1.0:
            pxr = state.x - ddx
            pyr = state.y - ddy
            pzr = state.z - ddz
            par = pxr * state.dx + pyr * state.dy + pzr * state.dz
            f = (cfg.pancake_factor - 1.0) / cfg.pancake_factor
            ddx = ddx + f * (pxr - par * state.dx)
            ddy = ddy + f * (pyr - par * state.dy)
            ddz = ddz + f * (pzr - par * state.dz)
        theta, phi = cart_to_sph(state.dx, state.dy, state.dz)
        s_theta, s_phi = cart_to_sph(state.start_dx, state.start_dy, state.start_dz)
        vals = dict(
            pos_x=state.x + hit_dist * state.dx - ddx,
            pos_y=state.y + hit_dist * state.dy - ddy,
            pos_z=state.z + hit_dist * state.dz - ddz,
            time=t_hit,
            dir_theta=theta, dir_phi=phi,
            wavelength=state.wlen,
            cherenkov_dist=state.total_path + hit_dist,
            num_scatters=state.num_scatters.astype(jnp.float32),
            weight=w_hit,
            identifier=steps.identifier.astype(jnp.float32),
            dom=hit_dom.astype(jnp.float32),
            start_x=state.start_x, start_y=state.start_y,
            start_z=state.start_z, start_time=state.start_t,
            start_theta=s_theta, start_phi=s_phi,
            group_velocity=1.0 / state.inv_groupvel,
            dist_in_abs_lens=state.abs_lens_initial - state.abs_lens_left,
        )
        rec = {k: ring_write(v, slot_pos, vals[k], rec_mask)
               for k, v in acc.rec.items() if not k.startswith("hist_")}
        if cfg.photon_history_entries > 0:
            # copy the photon's scatter-history ring into the record ring
            K_ = cfg.photon_capacity_per_slot
            cols = jax.lax.broadcasted_iota(jnp.int32,
                                            (slot_pos.shape[0], K_), 1)
            sel = ((cols == slot_pos[:, None]) & rec_mask[:, None])[..., None]
            for hk, hv in (("hist_x", state.hist_x), ("hist_y", state.hist_y),
                           ("hist_z", state.hist_z),
                           ("hist_abs", state.hist_abs)):
                rec[hk] = jnp.where(sel, hv[:, None, :], acc.rec[hk])
        acc = acc._replace(
            rec=rec,
            rec_count=acc.rec_count + rec_mask.astype(acc.rec_count.dtype))

    # --- advance ---
    state = state._replace(
        x=state.x + jnp.where(active, state.dx * d_prop, 0.0),
        y=state.y + jnp.where(active, state.dy * d_prop, 0.0),
        z=state.z + jnp.where(active, state.dz * d_prop, 0.0),
        t=state.t + jnp.where(active, state.inv_groupvel * d_prop, 0.0),
        total_path=state.total_path + jnp.where(active, d_prop, 0.0),
        abs_lens_left=jnp.where(active, abs_left, state.abs_lens_left))

    # --- scatter survivors ---
    do_scatter = scattered & active
    pdx, pdy, pdz = pre_scatter_transform(medium.anisotropy,
                                          state.dx, state.dy, state.dz)
    if medium.scattering.kind == "icecube":
        cos_s = mixed_cos(medium.scattering.mean_cos,
                          medium.scattering.liu_fraction, u[5], u[6])
    else:
        # water: liu_fraction is the Rayleigh fraction; the complement is a
        # tabulated (Petzold) angle distribution, sampled via the one-hot
        # interpolated-CDF path and converted with cos
        angle = sample_interpolated_fast(
            medium.scattering.table_cos,
            medium.scattering.table_cdf[0], medium.scattering.table_cdf[1],
            u[6])
        ray = rayleigh_cos(u[6])
        cos_s = jnp.where(u[5] < medium.scattering.liu_fraction, ray,
                          jnp.cos(angle))
    if use_score:
        # accumulate this segment's sampled-event log-likelihood: survival
        # -int b_eff ds over the traveled distance, plus (scattered lanes)
        # the exponential distance density's log b_eff(end) and the HG/Liu
        # mixture angle density at the detached sampled cosine.  All
        # sampled values are detached; only the medium parameters are
        # traced, so AD of exp(L - sg L) yields the likelihood-ratio
        # (score-function) gradient term.
        sgl = jax.lax.stop_gradient
        dL = -tau_seg_s + jnp.where(
            scattered, jnp.log(jnp.maximum(inv_s_fin, 1e-30)), 0.0)
        if medium.scattering.kind == "icecube":
            g = medium.scattering.mean_cos
            f = medium.scattering.liu_fraction
            c = sgl(cos_s)
            beta_l = (1.0 - g) / (1.0 + g)
            half = jnp.clip((1.0 + c) * 0.5, 1e-12, 1.0)
            log_liu = (-jnp.log(2.0 * beta_l)
                       + (1.0 / beta_l - 1.0) * jnp.log(half))
            denom = jnp.maximum(1.0 + g * g - 2.0 * g * c, 1e-12)
            log_hg = (jnp.log(jnp.maximum(0.5 * (1.0 - g * g), 1e-30))
                      - 1.5 * jnp.log(denom))
            fcl = jnp.clip(f, 1e-12, 1.0 - 1e-12)
            log_p_ang = jnp.where(u[5] < f,
                                  jnp.log(fcl) + log_liu,
                                  jnp.log(1.0 - fcl) + log_hg)
            dL = dL + jnp.where(scattered, log_p_ang, 0.0)
        # (tabulated water phase functions carry no parametric angle score)
        state = state._replace(
            log_lik=jnp.where(active, state.log_lik + dL, state.log_lik))
    sin_s = safe_sqrt(1.0 - cos_s * cos_s)
    sdx, sdy, sdz = scatter_direction_by_angle(cos_s, sin_s, pdx, pdy, pdz, u[7])
    sdx, sdy, sdz = post_scatter_transform(medium.anisotropy, sdx, sdy, sdz)
    if cfg.estimator == "expected" and cfg.detach_trajectories:
        sdx = jax.lax.stop_gradient(sdx)
        sdy = jax.lax.stop_gradient(sdy)
        sdz = jax.lax.stop_gradient(sdz)

    if cfg.photon_history_entries > 0:
        # ring-append the scatter point + current depth in absorption lengths
        # (propagation_kernel.c.cl:833-837)
        H = cfg.photon_history_entries
        hpos = state.num_scatters % H
        depth = state.abs_lens_initial - state.abs_lens_left
        state = state._replace(
            hist_x=ring_write(state.hist_x, hpos, state.x, do_scatter),
            hist_y=ring_write(state.hist_y, hpos, state.y, do_scatter),
            hist_z=ring_write(state.hist_z, hpos, state.z, do_scatter),
            hist_abs=ring_write(state.hist_abs, hpos, depth, do_scatter))

    state = state._replace(
        dx=jnp.where(do_scatter, sdx, state.dx),
        dy=jnp.where(do_scatter, sdy, state.dy),
        dz=jnp.where(do_scatter, sdz, state.dz),
        num_scatters=state.num_scatters + do_scatter.astype(state.num_scatters.dtype))

    # --- retire absorbed / detected photons (the reference kills a photon
    # whenever its remaining budget drops below EPSILON, loop top of
    # propagation_kernel.c.cl:536-596) ---
    died = active & (absorbed | (state.abs_lens_left < EPSILON))
    if stop_on_hit:
        died = died | (active & hit)
    state = state._replace(in_flight=state.in_flight & ~died)
    return state, acc


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _init_state(steps: StepBatch, history_entries: int = 0,
                score: bool = False) -> SlotState:
    n = steps.x.shape[0]
    zf = jnp.zeros(n, jnp.float32)
    zi = jnp.zeros(n, jnp.int32)
    zh = (jnp.zeros((n, history_entries), jnp.float32)
          if history_entries > 0 else None)
    return SlotState(
        photons_left=steps.num_photons.astype(jnp.int32),
        in_flight=jnp.zeros(n, bool),
        x=zf, y=zf, z=zf, t=zf, dx=zf, dy=zf, dz=jnp.ones(n, jnp.float32),
        wlen=jnp.full(n, 400.0, jnp.float32),
        inv_groupvel=jnp.full(n, 1.0 / 0.2, jnp.float32),
        abs_lens_left=zf, abs_lens_initial=zf,
        num_scatters=zi, total_path=zf,
        start_x=zf, start_y=zf, start_z=zf, start_t=zf,
        start_dx=zf, start_dy=zf, start_dz=jnp.ones(n, jnp.float32),
        hist_x=zh, hist_y=zh, hist_z=zh, hist_abs=zh,
        log_lik=zf if score else None)


def _init_acc(n_slots: int, n_doms: int, cfg: PropagationConfig) -> Accumulators:
    rec = None
    rec_count = None
    if cfg.save_photons:
        shape = (n_slots, cfg.photon_capacity_per_slot)
        fields = ["pos_x", "pos_y", "pos_z", "time", "dir_theta", "dir_phi",
                  "wavelength", "cherenkov_dist", "num_scatters", "weight",
                  "identifier", "dom", "start_x", "start_y", "start_z",
                  "start_time", "start_theta", "start_phi", "group_velocity",
                  "dist_in_abs_lens"]
        rec = {f: jnp.zeros(shape, jnp.float32) for f in fields}
        if cfg.photon_history_entries > 0:
            hshape = shape + (cfg.photon_history_entries,)
            for f in ("hist_x", "hist_y", "hist_z", "hist_abs"):
                rec[f] = jnp.zeros(hshape, jnp.float32)
        rec_count = jnp.zeros(n_slots, jnp.int32)
    return Accumulators(
        hist=jnp.zeros(n_doms * cfg.hist_n_bins, jnp.float32),
        n_generated=jnp.zeros((), jnp.float32),
        n_hits=jnp.zeros((), jnp.float32),
        weight_hits=jnp.zeros((), jnp.float32),
        rec_count=rec_count, rec=rec)


@functools.partial(jax.jit, static_argnames=("cfg", "max_iterations"))
def propagate(steps: StepBatch, medium: MediumProperties,
              geo: DetectorGeometry, spectra: SpectrumTable,
              key, cfg: PropagationConfig,
              max_iterations: int = 0) -> PropagationResult:
    """Propagate all photons of a (padded) step batch.

    `steps` must already be slot-assigned: exactly one step per slot (use
    sources.assign_steps_to_slots).  With max_iterations == 0 a while_loop
    runs until every slot is drained (forward-only); a positive value runs a
    reverse-differentiable bounded loop instead.
    """
    state = _init_state(steps, cfg.photon_history_entries,
                        score=(cfg.score_function
                               and cfg.estimator == "expected"
                               and cfg.detach_trajectories))
    acc = _init_acc(steps.x.shape[0], geo.n_doms, cfg)

    def body(carry):
        i, state, acc = carry
        state, acc = _iteration(i, state, acc, steps, medium, geo,
                                spectra, cfg, key)
        return (i + 1, state, acc)

    if max_iterations and max_iterations > 0:
        def fori_body(i, carry):
            state, acc = carry
            state, acc = _iteration(i, state, acc, steps, medium, geo,
                                    spectra, cfg, key)
            return (state, acc)
        state, acc = jax.lax.fori_loop(0, max_iterations,
                                       jax.checkpoint(fori_body), (state, acc))
        n_iter = jnp.asarray(max_iterations, jnp.int32)
    else:
        def cond(carry):
            _, state, _ = carry
            return jnp.any(state.in_flight | (state.photons_left > 0))
        n_iter, state, acc = jax.lax.while_loop(
            cond, body, (jnp.zeros((), jnp.int32), state, acc))

    return PropagationResult(
        hist=acc.hist.reshape(geo.n_doms, cfg.hist_n_bins),
        n_generated=acc.n_generated,
        n_hits=acc.n_hits,
        weight_hits=acc.weight_hits,
        n_iterations=n_iter,
        rec_count=acc.rec_count,
        rec=acc.rec)
