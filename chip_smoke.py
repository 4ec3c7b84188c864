"""Chip smoke test: the quickest proof that the propagation engine runs on a
GPU, at detector scale, through the entry points a user calls.

    python chip_smoke.py          # phases 1-4 on one card
    python chip_smoke.py --four   # only the four-card mesh path vs one card

Phases (one process; no CPU fallback; the first failure ends the run):
  1. lookups   ops.lookup helpers vs plain indexing, bit for bit, at the
               default matmul precision (TF32 may be on), at the widths of
               the 171-layer walk window table and the 86-string DOM tables
  2. oracle    engine vs the float64 oracle (validate/oracle.py), cascade
               protocol at the tests/test_oracle.py size, |z| < 5
  3. served    Simulation(save_photons, n_slots=2^20).simulate_hits on
               10 x 40 TeV e- cascades, 86-string geometry, 171-layer ice
               (the reference benchmark's event shape, benchmark.py:10-30)
  4. icefit    one IceFit step with score_function=True at the FIT.md size
  --four       make_sharded_propagate and one IceFit step on a 4-card mesh
               against the same steps on one card

Earlier lines say what each phase found; the last line of stdout is one
JSON object {"ok": true, "device": {"platform", "kind", "count"}}.  Exits
non-zero, printing no result, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

import jax
import jax.numpy as jnp

from clsim_tpu.util.runtime import (card_name_and_power_limit,
                                    device_summary, enable_compile_cache)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def require_gpu():
    """Refuse to run anywhere but on a GPU: a CPU run proves nothing
    about the card."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {platform!r}")


def _bits(a):
    """Bit patterns, with -0.0 read as +0.0 (a select-sum may turn one into
    the other; the values are equal)."""
    return (np.asarray(a, np.float32) + np.float32(0.0)).view(np.uint32)


def _z(a, b, var):
    return float((a - b) / np.sqrt(max(var, 1e-30)))


# ---------------------------------------------------------------------------
# phase 1: lookups
# ---------------------------------------------------------------------------

def _interp_indexed(x, xp, fp):
    """ops.lookup.interp_onehot's arithmetic on plainly indexed rows."""
    L = xp.shape[0]
    k = jnp.clip(jnp.searchsorted(xp, x, side="right") - 1, 0, L - 2)
    x0, x1, f0, f1 = xp[k], xp[k + 1], fp[k], fp[k + 1]
    t = jnp.clip((x - x0) / jnp.maximum(x1 - x0, 1e-30), 0.0, 1.0)
    return f0 + t * (f1 - f0)


def phase_lookups(n_lanes: int = 1 << 20, seed: int = 1) -> dict:
    from clsim_tpu.ops.lookup import (interp_onehot, onehot_gather,
                                      select_rows_exact,
                                      shifted_window_table)
    from clsim_tpu.types import PropagationConfig
    from clsim_tpu.workloads import (biased_cherenkov_spectra,
                                     icecube86_geometry, layered_ice)

    rng = np.random.default_rng(seed)
    medium = layered_ice()
    L = medium.n_layers
    # full-mantissa per-layer values: a constant table would hide rounding
    layers = [jnp.asarray(v * np.exp(0.3 * rng.standard_normal(L)),
                          jnp.float32) for v in (0.03, 0.008, 1.0)]
    K = PropagationConfig().max_layer_steps
    walk = jnp.concatenate([shifted_window_table(v, K) for v in layers],
                           axis=1)
    geo = icecube86_geometry()
    S, M, _ = geo.string_dom_rel.shape
    feats = geo.string_features[:, (0, 1, 4, 5, 6)]
    rel = geo.string_dom_rel.reshape(S, M * 4)
    spectra = biased_cherenkov_spectra(medium, geo)

    j0 = jnp.asarray(rng.integers(0, L, n_lanes), jnp.int32)
    s_idx = jnp.asarray(rng.integers(0, S, n_lanes), jnp.int32)
    wlen = jnp.asarray(rng.uniform(250.0, 700.0, n_lanes), jnp.float32)
    take = jax.jit(lambda t, i: t[i])
    cases = [
        ("onehot_gather walk window", jax.jit(onehot_gather)(walk, j0),
         take(walk, j0), walk.shape),
        ("select_rows_exact string frame",
         jax.jit(select_rows_exact)(feats, s_idx), take(feats, s_idx),
         feats.shape),
        ("onehot_gather string_dom_rel", jax.jit(onehot_gather)(rel, s_idx),
         take(rel, s_idx), rel.shape),
        ("interp_onehot wavelength bias",
         jax.jit(interp_onehot)(wlen, spectra.bias_x, spectra.bias_y),
         jax.jit(_interp_indexed)(wlen, spectra.bias_x, spectra.bias_y),
         spectra.bias_x.shape),
    ]
    found = {}
    for name, got, want, shape in cases:
        same = bool(np.array_equal(_bits(got), _bits(want)))
        print(f"  {name}: table {tuple(shape)}, {n_lanes} lanes, "
              f"bitwise equal {same}", flush=True)
        check(same, f"{name} differs from plain indexing")
        found[name] = same
    # what the split buys: one f32 pass at the default precision
    oh = jax.nn.one_hot(j0, L, dtype=jnp.float32)
    single = jax.jit(lambda o, t: o @ t)(oh, walk)
    found["single_pass_dot_exact"] = bool(
        np.array_equal(_bits(single), _bits(take(walk, j0))))
    print("  single-pass f32 one-hot dot at default precision bitwise "
          f"exact: {found['single_pass_dot_exact']}", flush=True)
    return found


# ---------------------------------------------------------------------------
# phase 2: engine vs float64 oracle
# ---------------------------------------------------------------------------

def phase_oracle(n_steps: int = 4096, photons_per_step: int = 24) -> dict:
    from clsim_tpu.propagate.engine import propagate
    from clsim_tpu.types import StepBatch
    from clsim_tpu.validate.oracle import oracle_propagate
    from clsim_tpu.validate.protocols import cascade_workload

    medium, geo, spectra, cfg, steps = cascade_workload()
    steps = StepBatch(*[np.asarray(f)[:n_steps] for f in steps])
    steps = steps._replace(
        num_photons=np.full(n_steps, photons_per_step, np.int32))
    res = propagate(StepBatch(*[jnp.asarray(f) for f in steps]), medium,
                    geo, spectra, jax.random.PRNGKey(3), cfg)
    e_hits = float(res.n_hits)
    e_hist = np.asarray(res.hist, np.float64)
    o_hist, o_hits, _ = oracle_propagate(
        steps, medium, geo,
        (np.asarray(spectra.x[0]), np.asarray(spectra.beta[0])),
        (np.asarray(spectra.bias_x), np.asarray(spectra.bias_y)),
        cfg, np.random.default_rng(123), photons_per_step=photons_per_step)
    check(float(res.n_generated) == n_steps * photons_per_step,
          f"engine generated {float(res.n_generated)} photons, "
          f"expected {n_steps * photons_per_step}")
    check(e_hits > 0 and o_hits > 0, "no hits on one side")
    # unbiased spectrum: every weight is 1, so counts are Poisson
    zs = {"total_hits": _z(e_hits, o_hits, e_hits + o_hits)}
    te = e_hist.sum(axis=0).reshape(10, -1).sum(axis=1)
    to = o_hist.sum(axis=0).reshape(10, -1).sum(axis=1)
    for k in range(10):
        if te[k] + to[k] >= 25:
            zs[f"time_bin_{k}"] = _z(te[k], to[k], te[k] + to[k])
    occ_e, occ_o = e_hist.sum(axis=1), o_hist.sum(axis=1)
    for d in np.argsort(occ_e + occ_o)[-10:]:
        zs[f"dom_{int(d)}"] = _z(occ_e[d], occ_o[d], occ_e[d] + occ_o[d])
    worst = max(zs, key=lambda k: abs(zs[k]))
    print(f"  {n_steps * photons_per_step} photons: engine {e_hits:.0f} "
          f"hits, oracle {o_hits} hits, total z {zs['total_hits']:+.2f}, "
          f"{len(zs)} statistics, worst |z| {abs(zs[worst]):.2f} "
          f"({worst})", flush=True)
    check(all(abs(z) < 5.0 for z in zs.values()),
          f"engine disagrees with the oracle: {worst} z={zs[worst]:+.2f}")
    return zs


# ---------------------------------------------------------------------------
# phase 3: the served path
# ---------------------------------------------------------------------------

def _benchmark_cascades(n_events, energy_gev, seed):
    from clsim_tpu.sources import Particle, ParticleType
    rng = np.random.default_rng(seed)
    return [Particle.cascade(
        ParticleType.EMinus,
        pos=tuple(rng.uniform((-100.0, -100.0, -300.0),
                              (100.0, 100.0, 300.0))),
        time=0.0, energy=energy_gev,
        zenith=float(np.arccos(rng.uniform(-1, 1))),
        azimuth=float(rng.uniform(0, 2 * np.pi)))
        for _ in range(n_events)]


def _ppc_yield(sim, particles):
    """Mean photon count of the PPC parameterization for EM cascades
    (sources/ppc.py: f * meanPhotonsPerMeter * nph * E)."""
    from clsim_tpu.constants import PPC_NPH_CONST, PPC_NPH_REF_DENSITY
    from clsim_tpu.sources.shower import shower_parameters
    gen = sim.step_generator
    nph = PPC_NPH_CONST * PPC_NPH_REF_DENSITY / gen.density
    return sum(shower_parameters(p.ptype, p.energy, gen.density).em_scale
               * gen.mean_photons_per_meter[gen._layer_for(p.z)]
               * nph * p.energy for p in particles)


def phase_served(n_events: int = 10, energy_gev: float = 40e3,
                 n_slots: int = 1 << 20, seed: int = 7) -> dict:
    from clsim_tpu.api import Simulation
    from clsim_tpu.propagate.engine import propagate
    from clsim_tpu.types import PropagationConfig, StepBatch
    from clsim_tpu.workloads import icecube86_geometry, layered_ice

    sim = Simulation(medium=layered_ice(), geometry=icecube86_geometry(),
                     config=PropagationConfig(save_photons=True,
                                              n_slots=n_slots))
    particles = _benchmark_cascades(n_events, energy_gev, seed)
    expected = _ppc_yield(sim, particles)

    t0 = time.perf_counter()
    batches = sim.steps_from_particles(particles,
                                       np.random.default_rng(seed + 1))
    host_s = time.perf_counter() - t0
    check(len(batches) == 1,
          f"{len(batches)} slot batches: records of all but the last are "
          "lost (ROADMAP Reach 2); the smoke needs a single batch")
    n_steps = int((np.asarray(batches[0].num_photons) > 0).sum())
    print(f"  {n_events} x {energy_gev:.0f} GeV e- cascades: {n_steps} "
          f"nonempty slots of {n_slots}, PPC mean yield {expected:.4g} "
          "photons", flush=True)
    compiled = propagate.lower(
        StepBatch(*[jnp.asarray(f) for f in batches[0]]), sim.medium,
        sim.geometry, sim.spectra, jax.random.PRNGKey(0),
        sim.config).compile()
    print(f"  propagate step memory_analysis: {compiled.memory_analysis()}",
          flush=True)

    t0 = time.perf_counter()
    dom, t, _ = sim.simulate_hits(particles, seed + 1)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    dom, t, _ = sim.simulate_hits(particles, seed + 2)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = jax.block_until_ready(sim.run_steps(batches, seed + 2))
    prop_s = time.perf_counter() - t0
    n_gen = float(res.n_generated)
    n_hits = float(res.n_hits)
    rec_count = np.asarray(res.rec_count)
    found = {"n_generated": n_gen, "n_hits": n_hits,
             "rec_count_sum": int(rec_count.sum()),
             "rec_count_max": int(rec_count.max()),
             "mcpes": int(dom.shape[0]), "cold_s": cold, "warm_s": warm,
             "host_steps_s": host_s, "propagate_s": prop_s,
             "n_iterations": int(res.n_iterations)}
    print(f"  simulate_hits: cold {cold:.3f} s (compile included), warm "
          f"{warm:.3f} s; {n_gen:.0f} photons generated "
          f"({n_gen / expected - 1:+.4f} vs PPC yield), {n_hits:.0f} hits, "
          f"sum(rec_count) {found['rec_count_sum']}, max rec_count "
          f"{found['rec_count_max']} (ring {sim.config.photon_capacity_per_slot}), "
          f"{found['mcpes']} MCPEs, {found['n_iterations']} loop iterations",
          flush=True)
    print(f"  timed apart: host step generation + slot assignment "
          f"{host_s:.3f} s; run_steps on the slot batch (transfer + device) "
          f"{prop_s:.3f} s", flush=True)
    check(found["rec_count_sum"] == n_hits,
          f"sum(rec_count) {found['rec_count_sum']} != n_hits {n_hits}")
    check(abs(n_gen / expected - 1.0) < 0.05,
          f"n_generated {n_gen} not within 5% of the PPC yield {expected}")
    check(found["mcpes"] > 0, "no MCPEs")
    check(np.isfinite(t).all() and (dom >= 0).all()
          and (dom < sim.geometry.n_doms).all(), "malformed MCPEs")
    return found


# ---------------------------------------------------------------------------
# phase 4 / --four: the ice fit and the mesh
# ---------------------------------------------------------------------------

def _fit_step(mesh, n_photons, max_iterations, key):
    """One IceFit SGD step (lr 1, so the update is minus the gradient) on
    per-layer log scales of a_dust400 and b400; returns (loss, grads)."""
    from clsim_tpu.parallel.mesh import (IceFit, make_sharded_propagate,
                                         shard_steps)
    from clsim_tpu.workloads import fit_workload

    medium, geo, spectra, cfg, steps = fit_workload(n_photons)
    n_dev = mesh.devices.size
    cfg = dataclasses.replace(cfg, n_slots=n_photons // n_dev)
    steps = shard_steps(steps, mesh)
    target = make_sharded_propagate(mesh, cfg)(
        steps, medium, geo, spectra, jnp.asarray([7, 1], jnp.uint32)).hist
    a0, b0 = medium.a_dust400, medium.b400

    def transform(p):
        return {"a_dust400": a0 * jnp.exp(p["log_sa"]),
                "b400": b0 * jnp.exp(p["log_sb"])}

    fit = IceFit(mesh, cfg, geo, spectra, learning_rate=1.0,
                 max_iterations=max_iterations, score_function=True,
                 param_transform=transform)
    rng = np.random.default_rng(5)
    params = {k: jnp.asarray(0.1 * rng.standard_normal(medium.n_layers),
                             jnp.float32) for k in ("log_sa", "log_sb")}
    new, loss = fit.step(params, medium, steps, key, target)
    grads = {k: np.asarray(params[k]) - np.asarray(new[k]) for k in params}
    return float(loss), grads


def phase_icefit(n_photons: int = 131072, max_iterations: int = 48) -> dict:
    from clsim_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(jax.devices()[:1])
    t0 = time.perf_counter()
    loss, grads = _fit_step(mesh, n_photons, max_iterations,
                            jnp.asarray([13, 5000], jnp.uint32))
    dt = time.perf_counter() - t0
    norms = {k: float(np.linalg.norm(g)) for k, g in grads.items()}
    print(f"  {n_photons} photons, T={max_iterations}: loss {loss:.6g}, "
          f"|grad| {norms} ({dt:.3f} s, compile included)", flush=True)
    check(np.isfinite(loss), f"loss {loss}")
    for k, g in grads.items():
        check(np.isfinite(g).all(), f"non-finite gradient in {k}")
    check(any(n > 0 for n in norms.values()), "all gradients zero")
    return {"loss": loss, **{f"grad_norm_{k}": v for k, v in norms.items()}}


def phase_four(n_dev: int = 4, per_dev_slots: int = 1 << 18,
               photons_per_slot: int = 15, fit_photons: int = 131072,
               fit_iterations: int = 48) -> dict:
    from clsim_tpu.geometry import hexagonal_geometry
    from clsim_tpu.medium.functions import DEFAULT_ICE_REF_INDEX
    from clsim_tpu.ops.spectrum import make_cherenkov_spectrum, stack_spectra
    from clsim_tpu.parallel.mesh import (make_mesh, make_sharded_propagate,
                                         shard_steps)
    from clsim_tpu.types import PropagationConfig
    from clsim_tpu.workloads import cascade_step_cloud, layered_ice

    devs = jax.devices()[:n_dev]
    check(len(devs) == n_dev, f"need {n_dev} devices, JAX has "
          f"{len(jax.devices())}")
    medium = layered_ice()
    geo = hexagonal_geometry(n_rings=4, oversize=5.0)
    # unbiased spectrum: unit weights, Poisson statistics
    spectra = stack_spectra([make_cherenkov_spectrum(
        DEFAULT_ICE_REF_INDEX, medium.min_wlen, medium.max_wlen)])
    n = per_dev_slots * n_dev
    steps = cascade_step_cloud(n, photons_per_slot)
    key = jnp.asarray([0, 99], jnp.uint32)
    out = {}
    for label, mesh in (("4 cards", make_mesh(devs)),
                        ("1 card", make_mesh(devs[:1]))):
        nd = mesh.devices.size
        cfg = PropagationConfig(n_slots=n // nd, pancake_factor=5.0,
                                hist_n_bins=512, max_layer_steps=4,
                                max_segment_m=35.0)
        run = make_sharded_propagate(mesh, cfg)
        st = shard_steps(steps, mesh)
        print(f"  {label}: step shards on "
              f"{[str(sh.device) for sh in st.x.addressable_shards]}",
              flush=True)
        jax.block_until_ready(run(st, medium, geo, spectra, key))
        t0 = time.perf_counter()
        res = jax.block_until_ready(run(st, medium, geo, spectra, key))
        dt = time.perf_counter() - t0
        out[label] = (float(res.n_generated), float(res.n_hits),
                      np.asarray(res.hist, np.float64), dt)
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
                 for d in devs]
        print(f"  {label}: {out[label][0]:.0f} photons, {out[label][1]:.0f} "
              f"hits, warm {dt:.3f} s; peak bytes per device {peaks}",
              flush=True)
    (g4, h4, hist4, t4), (g1, h1, hist1, t1) = out["4 cards"], out["1 card"]
    # exact while the f32 photon counter stays below 2^24
    check(g4 == g1 == n * photons_per_slot,
          f"n_generated {g4} (4 cards) vs {g1} (1 card), expected "
          f"{n * photons_per_slot}")
    zs = {"total_hits": _z(h4, h1, h4 + h1)}
    te = hist4.sum(axis=0).reshape(16, -1).sum(axis=1)
    to = hist1.sum(axis=0).reshape(16, -1).sum(axis=1)
    for k in range(16):
        if te[k] + to[k] >= 25:
            zs[f"time_bin_{k}"] = _z(te[k], to[k], te[k] + to[k])
    worst = max(zs, key=lambda k: abs(zs[k]))
    print(f"  4 cards vs 1 card: total-hits z {zs['total_hits']:+.2f}, "
          f"worst |z| {abs(zs[worst]):.2f} ({worst}) over {len(zs)} "
          f"statistics; warm time ratio 1 card / 4 cards {t1 / t4:.3f}",
          flush=True)
    check(all(abs(z) < 5.0 for z in zs.values()),
          f"4-card histogram inconsistent with 1 card: {worst}")

    fit = {}
    for label, mesh in (("4 cards", make_mesh(devs)),
                        ("1 card", make_mesh(devs[:1]))):
        loss, grads = _fit_step(mesh, fit_photons, fit_iterations,
                                jnp.asarray([13, 5000], jnp.uint32))
        norms = {k: float(np.linalg.norm(g)) for k, g in grads.items()}
        print(f"  IceFit step on {label}: loss {loss:.6g}, psum'd |grad| "
              f"{norms}", flush=True)
        check(np.isfinite(loss), f"loss {loss} on {label}")
        for k, g in grads.items():
            check(np.isfinite(g).all(), f"non-finite {k} gradient, {label}")
        fit[label] = (loss, norms)
    return {"zs": zs, "fit": fit}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh path vs one card")
    args = ap.parse_args(argv)

    require_gpu()
    print(f"cache dir: {enable_compile_cache()}", flush=True)
    print(f"jax {jax.__version__}, device_kind {jax.devices()[0].device_kind}"
          f", {len(jax.devices())} device(s)", flush=True)
    card = card_name_and_power_limit()
    print("card (nvidia-smi name, power.limit):", flush=True)
    print(card, flush=True)

    phases = ([("four", phase_four)] if args.four else
              [("lookups", phase_lookups), ("oracle", phase_oracle),
               ("served", phase_served), ("icefit", phase_icefit)])
    for name, fn in phases:
        t0 = time.perf_counter()
        print(f"phase {name}:", flush=True)
        fn()
        print(f"phase {name}: ok in {time.perf_counter() - t0:.3f} s "
              f"on {card.splitlines()[0]}", flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"peak_bytes_in_use (device 0): {stats.get('peak_bytes_in_use')}",
          flush=True)
    print(json.dumps({"ok": True, "device": device_summary()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
