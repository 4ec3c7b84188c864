"""Engine vs independent float64 oracle: the reference-contract test.

The round-1 golden tests were self-referential (goldens generated by the
engine itself).  clsim_tpu.validate.oracle is an independent, direct-
semantics float64 numpy restatement of propagation_kernel.c.cl /
sparse_collision_kernel.c.cl with NO shared propagation code and NO segment
cap, driven by an independent RNG stream.  Agreement here is statistical
(different streams), so the assertions are z-score / relative-tolerance
tests at the available photon count.  scripts/validate_oracle.py runs the
same comparison at >= 1e6 photons for the BASELINE configs.
"""

import numpy as np

import jax
import jax.numpy as jnp

from clsim_tpu.propagate.engine import propagate
from clsim_tpu.types import PropagationConfig, StepBatch
from clsim_tpu.validate.oracle import (OracleMedium, oracle_propagate,
                                       oracle_walk)
from clsim_tpu.validate.protocols import (PHOTONS_PER_STEP,
                                          cascade_workload as _workload,
                                          flasher_workload as _workload_flasher,
                                          muon_workload as _workload_muon)

def test_walk_matches_engine_deterministically():
    """Same budgets in -> same distances out: the oracle's unbounded layer
    walk must agree with the engine's capped fixed-trip walk wherever the
    cap does not bind (float32 vs float64, rtol ~1e-4)."""
    from clsim_tpu.propagate import engine as E

    medium, geo, spectra, cfg, steps = _workload()
    m = OracleMedium(medium)
    r = np.random.default_rng(11)
    n = 512
    x = r.uniform(-150, 150, n)
    y = r.uniform(-150, 150, n)
    z = r.uniform(-300, 300, n)
    costh = r.uniform(-1, 1, n)
    phi = r.uniform(0, 2 * np.pi, n)
    dx = np.sqrt(1 - costh ** 2) * np.cos(phi)
    dy = np.sqrt(1 - costh ** 2) * np.sin(phi)
    wlen = r.uniform(300, 600, n)
    sca = r.exponential(1.0, n)
    ab = r.exponential(1.0, n)

    d_scat_o, d_abs_o = oracle_walk(m, x, y, z, costh, wlen, sca.copy(),
                                    ab.copy())

    state = E._init_state(StepBatch(*[jnp.zeros(n, jnp.float32)
                                      if f not in ("dir_z", "beta", "weight")
                                      else jnp.ones(n, jnp.float32)
                                      for f in StepBatch._fields]))
    state = state._replace(
        x=jnp.asarray(x, jnp.float32), y=jnp.asarray(y, jnp.float32),
        z=jnp.asarray(z, jnp.float32),
        dx=jnp.asarray(dx, jnp.float32), dy=jnp.asarray(dy, jnp.float32),
        dz=jnp.asarray(costh, jnp.float32),
        wlen=jnp.asarray(wlen, jnp.float32),
        in_flight=jnp.ones(n, bool))
    big_cfg = PropagationConfig(n_slots=n, max_segment_m=1e9,
                                max_layer_steps=16)
    d_prop, absorbed, scattered, _ = E._segment_distances(
        state, medium, big_cfg, jnp.asarray(sca, jnp.float32),
        jnp.asarray(ab, jnp.float32))
    d_prop = np.asarray(d_prop, np.float64)
    d_expect = np.minimum(d_scat_o, d_abs_o)
    # keep comparisons where f32 budget rounding cannot flip the min
    ok = np.abs(d_scat_o - d_abs_o) > 1e-3 * d_expect
    rel = np.abs(d_prop - d_expect) / np.maximum(d_expect, 1e-6)
    assert np.quantile(rel[ok], 0.99) < 2e-3
    assert np.median(rel[ok]) < 2e-4
    assert (np.asarray(absorbed) == (d_abs_o < d_scat_o))[ok].mean() > 0.995


def test_engine_matches_oracle_statistically():
    """Full-loop statistical agreement: hit counts, weights and hit-time
    distribution from the engine (f32, capped segments, threefry) vs the
    oracle (f64, unbounded, numpy RNG)."""
    medium, geo, spectra, cfg, steps = _workload()
    steps_j = StepBatch(*[jnp.asarray(f) for f in steps])
    res = propagate(steps_j, medium, geo, spectra,
                    jax.random.PRNGKey(3), cfg)
    eng_hits = float(res.n_hits)
    eng_w = float(res.weight_hits)
    eng_hist = np.asarray(res.hist, np.float64)

    sx = np.asarray(spectra.x[0])
    sy = np.asarray(spectra.beta[0])
    rng = np.random.default_rng(123)
    o_hist, o_hits, o_w = oracle_propagate(
        steps, medium, geo, (sx, sy), (np.asarray(spectra.bias_x),
                                       np.asarray(spectra.bias_y)),
        cfg, rng, photons_per_step=PHOTONS_PER_STEP)

    # Poisson z-test on raw hit counts
    sigma = np.sqrt(eng_hits + o_hits)
    assert abs(eng_hits - o_hits) < 5.0 * sigma, (eng_hits, o_hits)
    # unbiased workload: every weight is exactly 1
    assert np.isclose(eng_w, eng_hits) and np.isclose(o_w, o_hits)

    # hit-time distribution: collapse DOMs, coarse 10-bin comparison with
    # per-bin Poisson errors scaled by the mean weight
    def coarse(h):
        t = h.sum(axis=0)
        return t.reshape(10, -1).sum(axis=1)

    te, to = coarse(eng_hist), coarse(o_hist)
    wbar = eng_w / eng_hits
    for k in range(10):
        if te[k] + to[k] < 25 * wbar:
            continue  # single-digit-count tails
        sig = wbar * np.sqrt((te[k] + to[k]) / wbar)
        assert abs(te[k] - to[k]) < 5.0 * sig, (k, te[k], to[k])

    # DOM occupancy: the top-10 hottest DOMs agree within 5 sigma
    occ_e = eng_hist.sum(axis=1)
    occ_o = o_hist.sum(axis=1)
    hot = np.argsort(occ_e + occ_o)[-10:]
    for d in hot:
        sig = wbar * np.sqrt((occ_e[d] + occ_o[d]) / wbar)
        assert abs(occ_e[d] - occ_o[d]) < 5.0 * sig, (d, occ_e[d], occ_o[d])


def test_bias_unfolding_matches_oracle_robustly():
    """Biased sampling + 1/bias weight unfolding: the per-hit weight
    distribution is heavy-tailed at the spectrum edges (weight -> 1/bias),
    so compare robust quantiles of the engine's recorded hit weights
    against the oracle's."""
    import dataclasses
    medium, geo, spectra, cfg, steps = _workload(bias=True)
    cfg = dataclasses.replace(cfg, save_photons=True,
                              photon_capacity_per_slot=8)
    steps_j = StepBatch(*[jnp.asarray(f) for f in steps])
    res = propagate(steps_j, medium, geo, spectra,
                    jax.random.PRNGKey(3), cfg)
    w = np.asarray(res.rec["weight"]).reshape(-1)
    w_eng = w[w > 0.0]

    sx = np.asarray(spectra.x[0])
    sy = np.asarray(spectra.beta[0])
    rng = np.random.default_rng(123)
    _, _, _, w_orc, _ = oracle_propagate(
        steps, medium, geo, (sx, sy),
        (np.asarray(spectra.bias_x), np.asarray(spectra.bias_y)),
        cfg, rng, photons_per_step=PHOTONS_PER_STEP, collect_weights=True)

    assert len(w_eng) > 300 and len(w_orc) > 300
    for q in (0.25, 0.5, 0.75):
        qe = np.quantile(w_eng, q)
        qo = np.quantile(w_orc, q)
        assert abs(qe - qo) / qo < 0.15, (q, qe, qo)


def _statistical_compare(eng_hits, eng_w, eng_hist, o_hits, o_w, o_hist):
    sigma = np.sqrt(eng_hits + o_hits)
    assert abs(eng_hits - o_hits) < 5.0 * sigma, (eng_hits, o_hits)
    assert np.isclose(eng_w, eng_hits) and np.isclose(o_w, o_hits)

    def coarse(h):
        return h.sum(axis=0).reshape(10, -1).sum(axis=1)

    te, to = coarse(eng_hist), coarse(o_hist)
    wbar = eng_w / max(eng_hits, 1.0)
    for k in range(10):
        if te[k] + to[k] < 25 * wbar:
            continue
        sig = wbar * np.sqrt((te[k] + to[k]) / wbar)
        assert abs(te[k] - to[k]) < 5.0 * sig, (k, te[k], to[k])
    occ_e, occ_o = eng_hist.sum(axis=1), o_hist.sum(axis=1)
    hot = np.argsort(occ_e + occ_o)[-10:]
    for d in hot:
        sig = wbar * np.sqrt((occ_e[d] + occ_o[d]) / wbar)
        assert abs(occ_e[d] - occ_o[d]) < 5.0 * sig, (d, occ_e[d], occ_o[d])


def test_muon_spice_lea_matches_oracle():
    """Config #2 smoke: muon track through a tilted, anisotropic layered
    medium (spice_lea's features; the parsed tables are not in the
    repository), engine vs
    oracle (scripts/validate_oracle.py --config muon runs this at >=1e6)."""
    medium, geo, spectra, cfg, steps = _workload_muon()
    steps_j = StepBatch(*[jnp.asarray(f) for f in steps])
    res = propagate(steps_j, medium, geo, spectra, jax.random.PRNGKey(3),
                    cfg)
    o_hist, o_hits, o_w = oracle_propagate(
        steps, medium, geo,
        (np.asarray(spectra.x[0]), np.asarray(spectra.beta[0])),
        (np.asarray(spectra.bias_x), np.asarray(spectra.bias_y)),
        cfg, np.random.default_rng(123), photons_per_step=PHOTONS_PER_STEP)
    assert float(res.n_hits) > 50 and o_hits > 50
    assert bool(medium.tilt.enabled) and bool(medium.anisotropy.enabled)
    _statistical_compare(float(res.n_hits), float(res.weight_hits),
                         np.asarray(res.hist, np.float64),
                         o_hits, o_w, o_hist)


def test_flasher_multi_spectrum_matches_oracle():
    """Config #3 smoke: flasher source_type dispatch, engine vs oracle."""
    medium, geo, spectra, cfg, steps, oracle_spectra = _workload_flasher()
    steps_j = StepBatch(*[jnp.asarray(f) for f in steps])
    res = propagate(steps_j, medium, geo, spectra, jax.random.PRNGKey(4),
                    cfg)
    o_hist, o_hits, o_w = oracle_propagate(
        steps, medium, geo, oracle_spectra,
        (np.asarray(spectra.bias_x), np.asarray(spectra.bias_y)),
        cfg, np.random.default_rng(321), photons_per_step=PHOTONS_PER_STEP)
    assert float(res.n_hits) > 50 and o_hits > 50
    _statistical_compare(float(res.n_hits), float(res.weight_hits),
                         np.asarray(res.hist, np.float64),
                         o_hits, o_w, o_hist)
