"""Bound the detailed-propagator approximation against the PPC
parameterization (round-4 review item 10): compare
DetailedCascadePropagator / DetailedMuonPropagator step output with the
PPC parameterization on (a) the photon-weighted longitudinal emission
profile, (b) the emission-angle distribution, and (c) -- with --propagate,
on the default JAX device -- the propagated hit-time distribution on the
bench detector, at three energies each.

The reference's Geant4 propagator (private/geant4/TrkCerenkov.cxx:120-619)
tracks every shower particle; both models here are reduced.  What this
script measures is how far the reduced detailed model's *distributions*
sit from the PPC parameterization that IceCube production itself uses
(PPC.cxx:749-843) -- the deviation bound DETAILED.md documents.

Outputs compare_detailed.npz in the temporary directory + a printed table.

    python scripts/compare_detailed.py [--propagate]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from clsim_tpu.medium.functions import DEFAULT_ICE_REF_INDEX  # noqa: E402
from clsim_tpu.medium.properties import make_homogeneous_ice  # noqa: E402
from clsim_tpu.ops.spectrum import make_cherenkov_spectrum  # noqa: E402
from clsim_tpu.sources.convert import (MuonSlicerPropagator,  # noqa: E402
                                       SourceConverter,
                                       default_parameterizations)
from clsim_tpu.sources.detailed import (DetailedCascadePropagator,  # noqa: E402
                                        DetailedMuonPropagator)
from clsim_tpu.sources.flasher import FlasherStepGenerator  # noqa: E402
from clsim_tpu.sources.particles import Particle, ParticleType  # noqa: E402
from clsim_tpu.sources.ppc import PPCStepGenerator  # noqa: E402
from clsim_tpu.types import StepBatch  # noqa: E402


def collect_steps(batches):
    """Concatenate numpy StepBatch list."""
    return StepBatch(*[np.concatenate([np.asarray(getattr(b, f))
                                       for b in batches])
                       for f in StepBatch._fields])


def axis_projection(steps, src, n_spread=8):
    """Depth along the source axis and cos(angle to axis), photon weights.

    Photons are emitted uniformly ALONG each step (the kernel spawns them
    at random offsets within the step length), so finite steps -- the PPC
    muon-like steps span the whole track -- spread their photon weight
    over n_spread sample points along the step instead of collapsing to
    one point."""
    d = np.array([src.dir_x, src.dir_y, src.dir_z])
    rx0 = np.asarray(steps.x, np.float64) - src.x
    ry0 = np.asarray(steps.y, np.float64) - src.y
    rz0 = np.asarray(steps.z, np.float64) - src.z
    ln = np.asarray(steps.length, np.float64)
    w = np.asarray(steps.num_photons, np.float64)
    cosang = (np.asarray(steps.dir_x) * d[0] + np.asarray(steps.dir_y) * d[1]
              + np.asarray(steps.dir_z) * d[2])
    depths, weights, cosas = [], [], []
    for j in range(n_spread):
        f = (j + 0.5) / n_spread
        depth = ((rx0 + f * ln * np.asarray(steps.dir_x)) * d[0]
                 + (ry0 + f * ln * np.asarray(steps.dir_y)) * d[1]
                 + (rz0 + f * ln * np.asarray(steps.dir_z)) * d[2])
        depths.append(depth)
        weights.append(w / n_spread)
        cosas.append(cosang)
    return (np.concatenate(depths), np.concatenate(cosas),
            np.concatenate(weights))


class HistAcc:
    """Seed-averaged photon-weighted (depth, cos) histograms."""

    def __init__(self, lim_depth, nbins=400):
        self.hd = np.zeros(nbins)
        self.hc = np.zeros(nbins)
        self.lim = lim_depth
        self.nbins = nbins
        self.sum_w = 0.0
        self.sum_d = 0.0
        self.sum_d2 = 0.0
        self.sum_c = 0.0
        self.sum_c2 = 0.0
        self.yields = []

    def add(self, depth, cosang, w):
        self.hd += np.histogram(depth, bins=self.nbins,
                                range=(0.0, self.lim), weights=w)[0]
        self.hc += np.histogram(cosang, bins=self.nbins, range=(-1.0, 1.0),
                                weights=w)[0]
        self.sum_w += w.sum()
        self.sum_d += (depth * w).sum()
        self.sum_d2 += (depth ** 2 * w).sum()
        self.sum_c += (cosang * w).sum()
        self.sum_c2 += (cosang ** 2 * w).sum()
        self.yields.append(w.sum())

    def stats(self):
        md = self.sum_d / self.sum_w
        sd = np.sqrt(max(self.sum_d2 / self.sum_w - md ** 2, 0.0))
        mc = self.sum_c / self.sum_w
        sc = np.sqrt(max(self.sum_c2 / self.sum_w - mc ** 2, 0.0))
        return md, sd, mc, sc

    def cdfs(self):
        return (np.cumsum(self.hd) / max(self.hd.sum(), 1e-300),
                np.cumsum(self.hc) / max(self.hc.sum(), 1e-300))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--propagate", action="store_true",
                    help="also propagate both step sets on the bench "
                         "detector and compare hit-time distributions")
    args = ap.parse_args()
    medium = make_homogeneous_ice(b400=0.04, a_dust400=0.01)
    spec = make_cherenkov_spectrum(DEFAULT_ICE_REF_INDEX, 265.0, 675.0)
    ppc = PPCStepGenerator(medium, spec, photons_per_step=200)
    flash = FlasherStepGenerator(spec)

    conv_ppc = SourceConverter(default_parameterizations(ppc, flash),
                               propagators=[MuonSlicerPropagator()])

    det_cascade = DetailedCascadePropagator(medium, spec,
                                            segment_length_m=0.5,
                                            beta_spread=0.01)
    det_muon = DetailedMuonPropagator(medium, spec)
    # detailed muon's stochastic-loss secondaries are served by the PPC
    # cascade parameterization (re-entering the chain)
    conv_det = SourceConverter(default_parameterizations(ppc, flash),
                               propagators=[det_muon, det_cascade])

    out = {}
    print(f"{'case':26s} {'model':9s} {'<depth>':>8s} {'sd':>7s} "
          f"{'<cos>':>7s} {'sd':>7s} {'KS_depth':>9s} {'KS_cos':>8s} "
          f"{'yield':>12s}")

    results_steps = {}

    def run_case(tag, make_src, lim_depth, n_seeds):
        accs = {}
        for name, conv in (("ppc", conv_ppc), ("detailed", conv_det)):
            acc = HistAcc(lim_depth)
            for s in range(n_seeds):
                rng = np.random.default_rng(1000 + s)
                src = make_src()
                steps = collect_steps(conv.convert([(src, 0)], rng))
                if s == 0:
                    results_steps[f"{tag}_{name}"] = steps
                acc.add(*axis_projection(steps, src))
            accs[name] = acc
        cdp_d, cdp_c = accs["ppc"].cdfs()
        cdd_d, cdd_c = accs["detailed"].cdfs()
        ks_d = float(np.abs(cdp_d - cdd_d).max())
        ks_c = float(np.abs(cdp_c - cdd_c).max())
        yp = np.asarray(accs["ppc"].yields)
        yd = np.asarray(accs["detailed"].yields)
        for name, acc in accs.items():
            md, sd, mc, sc = acc.stats()
            y = acc.sum_w / n_seeds
            print(f"{tag:26s} {name:9s} {md:8.3f} {sd:7.3f} {mc:7.4f} "
                  f"{sc:7.4f} {ks_d:9.4f} {ks_c:8.4f} {y:12.3e}")
        yr = yd.mean() / yp.mean()
        yr_err = yr * np.sqrt(yd.std() ** 2 / yd.mean() ** 2
                              + yp.std() ** 2 / yp.mean() ** 2) \
            / np.sqrt(n_seeds)
        print(f"{'':26s} yield ratio det/ppc = {yr:.4f} +- {yr_err:.4f} "
              f"({n_seeds} events)")
        out[tag] = dict(ks_depth=ks_d, ks_cos=ks_c,
                        ppc_stats=accs["ppc"].stats(),
                        det_stats=accs["detailed"].stats(),
                        yield_ratio=yr, yield_ratio_err=yr_err,
                        hd_ppc=accs["ppc"].hd, hd_det=accs["detailed"].hd,
                        hc_ppc=accs["ppc"].hc, hc_det=accs["detailed"].hc)

    for E, n_seeds in ((1.0, 64), (100.0, 32), (1e4, 4)):
        run_case(f"cascade_{E:g}",
                 lambda E=E: Particle.cascade(
                     ParticleType.EMinus, (0.0, 0.0, 0.0), 0.0, E,
                     zenith=np.pi / 2, azimuth=np.pi),
                 lim_depth=30.0, n_seeds=n_seeds)

    L = 400.0
    for E, n_seeds in ((100.0, 48), (1e3, 48), (1e4, 16)):
        run_case(f"muon_{E:g}",
                 lambda E=E: Particle(
                     ptype=ParticleType.MuMinus, x=0.0, y=0.0, z=0.0,
                     time=0.0, energy=E, dir_x=1.0, dir_y=0.0, dir_z=0.0,
                     length=L),
                 lim_depth=L, n_seeds=n_seeds)

    # ---- hit-time distributions on the bench detector -------------------
    if args.propagate:
        import time

        import jax.numpy as jnp

        from bench import build_workload
        from clsim_tpu.propagate.dispatch import propagate_auto
        from clsim_tpu.sources.ppc import assign_steps_to_slots
        from clsim_tpu.util.runtime import enable_compile_cache

        enable_compile_cache()
        medium_b, geo_b, spectra_b, cfg_b, _ = build_workload(
            "hex61", 262144, 200)

        for case in ("cascade_100", "cascade_10000", "muon_1000"):
            hists = {}
            for name in ("ppc", "detailed"):
                steps = results_steps[f"{case}_{name}"]
                slot_batches = assign_steps_to_slots(steps, 262144)
                total = None
                t0 = time.perf_counter()
                for i, b in enumerate(slot_batches):
                    bj = StepBatch(*[jnp.asarray(f) for f in b])
                    res = propagate_auto(bj, medium_b, geo_b, spectra_b,
                                         1000 + i, cfg_b)
                    h = np.asarray(res.hist, np.float64).sum(axis=0)
                    total = h if total is None else total + h
                hists[name] = total
                print(f"{case} {name}: propagated in "
                      f"{time.perf_counter()-t0:.1f}s, "
                      f"hits={total.sum():.3e}", flush=True)
            hp, hd = hists["ppc"], hists["detailed"]
            # normalized time-distribution comparison over the 512 bins
            cp = np.cumsum(hp) / hp.sum()
            cd = np.cumsum(hd) / hd.sum()
            ks = np.abs(cp - cd).max()
            t_bins = np.linspace(0, 3000, hp.shape[0])
            med_p = t_bins[np.searchsorted(cp, 0.5)]
            med_d = t_bins[np.searchsorted(cd, 0.5)]
            print(f"{case}: hit-time KS={ks:.4f}, median ppc={med_p:.0f} ns "
                  f"detailed={med_d:.0f} ns, total-hit ratio "
                  f"{hd.sum()/hp.sum():.4f}")
            out[f"hits_{case}"] = dict(ks=ks, med_ppc=med_p, med_det=med_d,
                                       ratio=hd.sum() / hp.sum(),
                                       hist_ppc=hp, hist_det=hd)

    path = os.path.join(tempfile.gettempdir(), "compare_detailed.npz")
    np.savez(path, **{k: np.asarray(v, dtype=object) for k, v in out.items()})
    print(f"saved {path}")


if __name__ == "__main__":
    main()
