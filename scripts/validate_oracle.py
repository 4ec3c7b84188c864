"""Large-N engine-vs-oracle validation (the BASELINE correctness protocol).

Runs >= 1e6 photons through both the JAX engine (on the default JAX device)
and the independent float64 numpy oracle (clsim_tpu/validate/oracle.py),
then compares:

  * total hit counts (Poisson z-score)
  * the DOM-summed hit-time histogram in coarse bins (per-bin z-scores)
  * per-DOM occupancy of the hottest DOMs

This replicates the role of the reference's compareToPPC golden comparison
(SURVEY.md section 4.3) with the oracle standing in for the independent
implementation (OpenCL cannot run in this environment).  Protocol: pinned
seeds on both sides, agreement required at |z| < 5 for every statistic.

Usage:  python scripts/validate_oracle.py [n_photons] [--config NAME]

Configs (the BASELINE correctness matrix):
  cascade  -- #1: cascade-like isotropic steps, tilt + anisotropy (default)
  muon     -- #2: muon track through a tilted, anisotropic layered medium
  flasher  -- #3: LED flasher pulses (multi-spectrum source_type dispatch)
  cascade-biased -- #4: config #1 with the dom2007a wavelength bias ON:
              the PRODUCTION weighted path (weight = step.weight/bias), with
              z-scores using full sum(w^2) effective-variance propagation
              (round-3 review item 10)
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp

from clsim_tpu.validate.protocols import (cascade_workload,
                                          flasher_workload, muon_workload)
from clsim_tpu.propagate.dispatch import propagate_auto
from clsim_tpu.types import StepBatch
from clsim_tpu.util.runtime import device_summary, enable_compile_cache
from clsim_tpu.validate.oracle import oracle_propagate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("n_photons", nargs="?", type=int, default=1_000_000)
    ap.add_argument("--config", choices=["cascade", "muon", "flasher",
                                         "cascade-biased"],
                    default="cascade")
    args = ap.parse_args()
    enable_compile_cache()
    n_photons = args.n_photons
    # unbiased spectra: every hit weight is exactly 1, so Poisson z-scores
    # are valid.  (With the bias on, weights are heavy-tailed ~1/bias and a
    # per-bin z needs full sum(w^2) error propagation; the bias-unfolding
    # contract is covered by robust quantiles in tests/test_oracle.py.)
    biased = args.config == "cascade-biased"
    if args.config in ("cascade", "cascade-biased"):
        medium, geo, spectra, cfg, steps = cascade_workload(bias=biased)
        oracle_spectra = (np.asarray(spectra.x[0]),
                          np.asarray(spectra.beta[0]))
    elif args.config == "muon":
        medium, geo, spectra, cfg, steps = muon_workload()
        oracle_spectra = (np.asarray(spectra.x[0]),
                          np.asarray(spectra.beta[0]))
    else:
        (medium, geo, spectra, cfg, steps,
         oracle_spectra) = flasher_workload()
    n_steps = steps.x.shape[0]
    pps = max(1, n_photons // n_steps)
    steps = steps._replace(num_photons=np.full(n_steps, pps, np.int32))
    print(f"{n_steps} steps x {pps} photons = {n_steps*pps}")

    if biased:
        # per-hit records on the engine side: the weighted-path contract
        # needs per-hit (dom, time, weight), not just weighted sums
        # (round-4 review item 4 -- the old single w2bar z had almost no
        # power against a broken weighted path)
        import dataclasses
        # capacity must cover a worst-case slot (a beam aimed straight at
        # a DOM can convert nearly every photon of the slot into a hit)
        cap = pps + 8
        cfg = dataclasses.replace(cfg, save_photons=True,
                                  photon_capacity_per_slot=cap)

    steps_j = StepBatch(*[jnp.asarray(f) for f in steps])
    t0 = time.perf_counter()
    res = propagate_auto(steps_j, medium, geo, spectra, 3, cfg)
    eng_hits = float(res.n_hits)
    eng_hist = np.asarray(res.hist, np.float64)
    print(f"engine: {eng_hits:.0f} hits in {time.perf_counter()-t0:.1f}s "
          f"on {device_summary()}")

    e_w = e_flat = None
    if biased:
        from clsim_tpu.hits.photons import (photon_batch_dom_index,
                                            records_to_photon_batch)
        # the per-slot record rings have a fixed capacity
        _rcmax = int(np.max(np.asarray(res.rec_count)))
        assert _rcmax < cap, \
            f"record ring overflow ({_rcmax} >= {cap}): raise capacity"
        batch = records_to_photon_batch(
            {k: np.asarray(v) for k, v in res.rec.items()},
            np.asarray(res.rec_count), geo)
        dom = np.asarray(photon_batch_dom_index(batch, geo))
        tb = np.clip(((np.asarray(batch.time, np.float64) - cfg.hist_t_min)
                      / cfg.hist_dt), 0, cfg.hist_n_bins - 1)
        e_flat = dom * cfg.hist_n_bins + np.floor(tb).astype(np.int64)
        e_w = np.asarray(batch.weight, np.float64)
        valid = np.asarray(batch.valid)
        e_flat, e_w = e_flat[valid], e_w[valid]

    t0 = time.perf_counter()
    out = oracle_propagate(
        steps, medium, geo, oracle_spectra,
        (np.asarray(spectra.bias_x), np.asarray(spectra.bias_y)),
        cfg, np.random.default_rng(123), photons_per_step=pps,
        collect_weights=biased)
    if biased:
        o_hist, o_hits, o_w, o_weights, o_flat = out
    else:
        o_hist, o_hits, o_w = out
    print(f"oracle: {o_hits} hits in {time.perf_counter()-t0:.1f}s")

    z_tot = (eng_hits - o_hits) / np.sqrt(eng_hits + o_hits)
    print(f"total-hits z = {z_tot:+.2f}")
    fails = int(abs(z_tot) >= 5)
    if biased:
        # (a) per-hit weight-LAW comparison: robust quantiles of the two
        # weight distributions must agree to 10% -- catches bias-curve /
        # unfolding bugs the heavy-tailed sums cannot resolve
        print("weight-law quantiles (engine / oracle / rel diff / "
              "threshold):")
        boot = np.random.default_rng(7)
        for q in (0.25, 0.5, 0.75, 0.9):
            qe = float(np.quantile(e_w, q))
            qo = float(np.quantile(o_weights, q))
            rd = abs(qe - qo) / qo
            # statistics-aware bar: 10% systematic, widened only when the
            # bootstrap says the sample cannot resolve 10% (small runs)
            se2 = 0.0
            for arr in (e_w, o_weights):
                bs = [np.quantile(boot.choice(arr, len(arr)), q)
                      for _ in range(100)]
                se2 += np.var(bs)
            thr = max(0.10, 5.0 * np.sqrt(se2) / qo)
            flag = "  <-- FAIL" if rd > thr else ""
            print(f"  q{int(q*100):02d} {qe:12.4f} {qo:12.4f} "
                  f"{rd:8.4f} {thr:8.4f}{flag}")
            fails += int(rd > thr)
        # (b) CLAMPED-weight histograms: both sides clamp at the oracle's
        # q99 weight (identical treatment, so equality of implementations
        # is still exactly what is tested) -- bounded per-entry variance
        # restores per-bin power the raw 1/bias tail destroys.  Exact
        # per-bin sum(w^2) variances from the per-hit records.
        w_cap = float(np.quantile(o_weights, 0.99))
        print(f"clamped-weight comparison (cap = oracle q99 = {w_cap:.3f}):")
        e_wc = np.minimum(e_w, w_cap)
        o_wc = np.minimum(o_weights, w_cap)
        n_bins_t = cfg.hist_n_bins
        # EQUAL-COUNT time bins from the oracle's hit-time quantiles: ten
        # fixed coarse bins left the tail bins useless; quantile bins give
        # every bin comparable statistics and hence comparable sensitivity
        tf_e = e_flat % n_bins_t
        tf_o = o_flat % n_bins_t
        n_qb = 8
        edges = np.unique(np.quantile(tf_o, np.linspace(0, 1, n_qb + 1)
                                      )[1:-1])
        be = np.digitize(tf_e, edges)
        bo = np.digitize(tf_o, edges)
        nqb = len(edges) + 1
        te_c = np.bincount(be, weights=e_wc, minlength=nqb)
        ve_c = np.bincount(be, weights=e_wc ** 2, minlength=nqb)
        to_c = np.bincount(bo, weights=o_wc, minlength=nqb)
        vo_c = np.bincount(bo, weights=o_wc ** 2, minlength=nqb)
        usable = 0
        print("  equal-count time bins (engine / oracle / z / 5sig rel "
              "sensitivity):")
        for k in range(nqb):
            if te_c[k] + to_c[k] <= 0 or ve_c[k] + vo_c[k] <= 0:
                continue
            sig = np.sqrt(ve_c[k] + vo_c[k])
            z = (te_c[k] - to_c[k]) / sig
            sens = 5.0 * sig / (0.5 * (te_c[k] + to_c[k]))
            if sens <= 0.25:
                usable += 1
            flag = "  <-- FAIL" if abs(z) >= 5 else ""
            print(f"  [{k}] {te_c[k]:12.1f} {to_c[k]:12.1f} {z:+6.2f} "
                  f"{sens:8.3f}{flag}")
            fails += int(abs(z) >= 5)
        print(f"  usable clamped bins (5sig sensitivity <= 25%): {usable}")
        if usable < 4:
            print("  <-- FAIL: need >= 4 usable weighted time bins")
            fails += 1
        # (c) the raw (unclamped) weighted totals stay as a loose check
        w2bar = float((o_weights ** 2).sum()
                      / max(o_weights.sum(), 1e-9))
        We, Wo = eng_hist.sum(), o_hist.sum()
        z_w = (We - Wo) / np.sqrt(w2bar * (We + Wo))
        print(f"total-weight z = {z_w:+.2f}  (w2bar {w2bar:.2f}; loose "
              "tail-dominated check)")
        fails += int(abs(z_w) >= 5)

    # coarse weighted time histogram with effective-count errors
    te = eng_hist.sum(axis=0).reshape(10, -1).sum(axis=1)
    to = o_hist.sum(axis=0).reshape(10, -1).sum(axis=1)
    wbar = max(eng_hist.sum() / max(eng_hits, 1), 1e-9)
    if biased:
        # heavy-tailed weights: the effective per-entry variance is w2bar
        # (= sum w^2 / sum w), not the mean weight
        wbar = max(w2bar, 1e-9)
    print("time bins (engine / oracle / z):")
    for k in range(10):
        if te[k] + to[k] < 25 * wbar:
            continue
        z = (te[k] - to[k]) / (wbar * np.sqrt((te[k] + to[k]) / wbar))
        flag = "  <-- FAIL" if abs(z) >= 5 else ""
        print(f"  [{k}] {te[k]:12.1f} {to[k]:12.1f} {z:+6.2f}{flag}")
        fails += int(abs(z) >= 5)

    occ_e = eng_hist.sum(axis=1)
    occ_o = o_hist.sum(axis=1)
    hot = np.argsort(occ_e + occ_o)[-10:]
    worst = 0.0
    for d in hot:
        z = (occ_e[d] - occ_o[d]) / (
            wbar * np.sqrt((occ_e[d] + occ_o[d]) / wbar))
        worst = max(worst, abs(z))
        fails += int(abs(z) >= 5)
    print(f"hottest-10 DOM occupancy worst |z| = {worst:.2f}")
    print("PASS" if fails == 0 else f"FAIL ({fails} statistics over 5 sigma)")
    return 0 if fails == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
