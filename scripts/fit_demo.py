"""End-to-end ice-model recovery fit through the engine: take the
171-layer bench ice, perturb per-layer b400 / a_dust400 inside the
instrumented depth band and the anisotropy k1 (log-magnitude mag_along),
generate a synthetic target with the expected-estimator forward at TRUTH
parameters, and fit the perturbed model back with
IceFit(score_function=True) + optax adam in log-parameter space.  Also runs
the same fit with the DETACHED estimator (score_function=False) to show why
the score term is the default for scattering fits.

This is the differentiability north star as a deliverable: the reference
(clsim) has no gradients at all; ice models there are fitted by
grid-searching forward simulations against flasher data.

Outputs one npz (FIT_OUT, default fit_demo.npz in the temporary directory)
with parameter/loss traces + wall-clock, consumed by FIT.md.

Env knobs: FIT_SLOTS (32768), FIT_ITERS (48), FIT_STEPS (300),
FIT_STEPS_DETACHED (120), FIT_TARGET_AVG (16), FIT_LR (0.02),
FIT_MODE (scattering | absorption | k1), FIT_GROUPS (0 = one per layer).
On a CPU-only JAX the defaults shrink to a smoke-sized run.

    python scripts/fit_demo.py
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from clsim_tpu.parallel.mesh import IceFit, make_mesh, shard_steps  # noqa: E402
from clsim_tpu.propagate.engine import propagate  # noqa: E402
from clsim_tpu.types import StepBatch  # noqa: E402
from clsim_tpu.util.runtime import enable_compile_cache  # noqa: E402
from clsim_tpu.workloads import fit_workload  # noqa: E402


def main():
    enable_compile_cache()
    small = jax.devices()[0].platform == "cpu"
    n_slots = int(os.environ.get("FIT_SLOTS", 512 if small else 32768))
    T = int(os.environ.get("FIT_ITERS", 8 if small else 48))
    n_steps = int(os.environ.get("FIT_STEPS", 6 if small else 300))
    n_steps_det = int(os.environ.get("FIT_STEPS_DETACHED",
                                     3 if small else 120))
    n_target = int(os.environ.get("FIT_TARGET_AVG", 2 if small else 16))
    lr = float(os.environ.get("FIT_LR", 0.02))
    out_path = os.environ.get(
        "FIT_OUT", os.path.join(tempfile.gettempdir(), "fit_demo.npz"))

    medium, geo, spectra, cfg, steps = fit_workload(n_slots)

    nl = medium.n_layers
    z0 = float(np.asarray(medium.layers_z_start))
    dz = float(np.asarray(medium.layer_height))
    # instrumented band: layers whose centers lie in [-350, 350]
    centers = z0 + (np.arange(nl) + 0.5) * dz
    band = np.where((centers > -350.0) & (centers < 350.0))[0]
    lo, hi = int(band[0]), int(band[-1]) + 1
    if small:
        lo, hi = lo + 25, lo + 29   # tiny band for the smoke run
    print(f"layers {nl}, fit band [{lo},{hi}) = {hi-lo} layers, "
          f"slots {n_slots}, T {T}, steps {n_steps}", flush=True)

    b_true = np.asarray(medium.b400, np.float64)
    a_true = np.asarray(medium.a_dust400, np.float64)
    k1_true = float(np.asarray(medium.anisotropy.mag_along)) \
        if medium.anisotropy is not None else 0.0
    print(f"truth k1(mag_along) = {k1_true:.4f}", flush=True)

    # perturbation: +-20% lognormal per group inside the band; k1 +0.05
    k1_pert = k1_true + 0.05

    b_lo = jnp.asarray(b_true[:lo], jnp.float32)
    b_hi = jnp.asarray(b_true[hi:], jnp.float32)
    a_lo = jnp.asarray(a_true[:lo], jnp.float32)
    a_hi = jnp.asarray(a_true[hi:], jnp.float32)
    aniso_true = medium.anisotropy

    # parameterization: per-GROUP log scale factors over the band
    # (FIT_GROUPS contiguous groups; FIT_GROUPS=0 -> one per layer).
    # Why groups: the per-step gradient SNR at this photon budget was
    # MEASURED below 1 even for the global-b direction (scripts/
    # probe_grad run, FIT.md), so a 141-parameter per-layer fit is
    # information-starved regardless of estimator quality; grouped
    # scales carry ~10x the per-parameter signal.
    # FIT_MODE=absorption: per-layer a_dust400 recovery on the
    # DETERMINISTIC shared-stream (CRN) loss -- the absorption gradient is
    # exact reparameterized AD (no sampling-law dependence), so the fit
    # descends a noise-free bowl whose zero is at truth (verified:
    # loss(truth) == 0.0 exactly on this workload).  FIT_MODE=scattering
    # (default): grouped b400/a_dust scales + k1 by expectation matching
    # with the two-sample score-function gradient.
    mode = os.environ.get("FIT_MODE", "scattering")
    n_band = hi - lo
    n_groups = int(os.environ.get("FIT_GROUPS", 0)) or n_band
    gidx = np.minimum((np.arange(n_band) * n_groups) // n_band,
                      n_groups - 1)
    gidx_j = jnp.asarray(gidx)
    b_band = jnp.asarray(b_true[lo:hi], jnp.float32)
    a_band = jnp.asarray(a_true[lo:hi], jnp.float32)

    fit_b = mode not in ("absorption", "k1")
    fit_a = mode != "k1"

    def transform(p):
        out = {}
        if fit_a:
            sa = jnp.exp(p["log_sa"])[gidx_j]
            out["a_dust400"] = jnp.concatenate([a_lo, a_band * sa, a_hi])
        if fit_b:
            sb = jnp.exp(p["log_sb"])[gidx_j]
            out["b400"] = jnp.concatenate([b_lo, b_band * sb, b_hi])
        if mode != "absorption" and aniso_true is not None:
            out["anisotropy"] = aniso_true._replace(
                mag_along=p["k1"].reshape(()))
        return out

    # perturbation in group space: the truth scale factor is 1 per group
    pr2 = np.random.default_rng(1234)
    sb_pert = np.exp(0.2 * pr2.standard_normal(n_groups)) if fit_b \
        else np.ones(n_groups)
    sa_pert = np.exp(0.2 * pr2.standard_normal(n_groups)) if fit_a \
        else np.ones(n_groups)
    params0 = {}
    if fit_a:
        params0["log_sa"] = jnp.asarray(np.log(sa_pert), jnp.float32)
    if fit_b:
        params0["log_sb"] = jnp.asarray(np.log(sb_pert), jnp.float32)
    if mode != "absorption" and aniso_true is not None:
        params0["k1"] = jnp.asarray(k1_pert, jnp.float32)
    b_pert = b_true.copy()
    a_pert = a_true.copy()
    b_pert[lo:hi] = b_true[lo:hi] * sb_pert[gidx]
    a_pert[lo:hi] = a_true[lo:hi] * sa_pert[gidx]

    mesh = make_mesh()
    steps_sharded = shard_steps(steps, mesh)
    steps_j = StepBatch(*[jnp.asarray(f) for f in steps])

    # ---- synthetic target at TRUTH parameters ----------------------------
    # Expectation matching: the target is the truth forward AVERAGED over
    # n_target independent keys; each fit step draws a FRESH key pair and
    # the two-sample loss gradient (IceFit(two_sample=True)) is unbiased
    # for grad ||E[hist] - target||^2.  (Two designs that FAIL here, both
    # measured: (a) fresh keys against a fixed target with the plain chi2
    # adds a Var(hist) penalty that drags the fit away from truth; (b) a
    # shared-stream CRN loss IS exactly zero at truth -- verified on this
    # workload -- but the score-function estimator targets expectation
    # gradients, not realized-stream gradients, so its fixed point is not
    # the CRN minimum either.)
    @jax.jit
    def target_fwd(key):
        return propagate(steps_j, medium, geo, spectra,
                         jax.random.fold_in(key, 0), cfg,
                         max_iterations=T).hist

    key_crn = jnp.asarray([13, 777], jnp.uint32)
    t0 = time.perf_counter()
    if mode == "absorption":
        # CRN: target on the SAME stream every fit step uses -> the loss
        # is deterministic with its exact zero at truth
        target = target_fwd(key_crn)
        print(f"target built (CRN, shared stream) in "
              f"{time.perf_counter()-t0:.1f}s, sum={float(target.sum()):.1f}",
              flush=True)
    else:
        tgt = None
        for i in range(n_target):
            h = target_fwd(jnp.asarray([7, 1000 + i], jnp.uint32))
            tgt = h if tgt is None else tgt + h
        target = tgt / n_target
        print(f"target built ({n_target}-key average) in "
              f"{time.perf_counter()-t0:.1f}s, sum={float(target.sum()):.1f}",
              flush=True)

    # ---- the fit --------------------------------------------------------
    def run_fit(score, steps_n, tag):
        sched = optax.exponential_decay(lr, max(steps_n // 3, 1), 0.5)
        fit = IceFit(mesh, cfg, geo, spectra, score_function=score,
                     max_iterations=T,
                     optimizer=optax.adam(sched), param_transform=transform,
                     loss="chi2",
                     two_sample=(mode != "absorption"))
        params = {k: jnp.asarray(v) for k, v in params0.items()}
        losses, traces, times = [], [], []
        t_start = time.perf_counter()
        for it in range(steps_n):
            t1 = time.perf_counter()
            key_it = key_crn if mode == "absorption" \
                else jnp.asarray([13, 5000 + it], jnp.uint32)
            params, loss = fit.step(params, medium, steps_sharded, key_it,
                                    target)
            params = {k: jnp.asarray(v) for k, v in params.items()}
            losses.append(float(loss))        # syncs
            times.append(time.perf_counter() - t1)
            traces.append({k: np.asarray(v, np.float64)
                           for k, v in params.items()})
            if it % 10 == 0 or it == steps_n - 1:
                k1v = float(params.get("k1", jnp.nan))
                rms_b = float(np.sqrt(np.mean(
                    (np.exp(traces[-1].get("log_sb", np.zeros(1)))
                     - 1.0) ** 2)))
                rms_a = float(np.sqrt(np.mean(
                    (np.exp(traces[-1].get("log_sa", np.zeros(1)))
                     - 1.0) ** 2)))
                print(f"[{tag}] step {it:4d} loss {losses[-1]:.4f} "
                      f"rel-RMS(b scales) {rms_b:.4f} rel-RMS(a scales) "
                      f"{rms_a:.4f} k1 {k1v:.4f} "
                      f"({times[-1]*1e3:.0f} ms)", flush=True)
        wall = time.perf_counter() - t_start
        return params, losses, traces, times, wall

    params_s, loss_s, tr_s, times_s, wall_s = run_fit(
        None if mode == "absorption" else True, n_steps, mode)
    if mode == "absorption":
        params_d, loss_d, tr_d, times_d, wall_d = (
            params_s, loss_s, tr_s, times_s, wall_s)
    else:
        params_d, loss_d, tr_d, times_d, wall_d = run_fit(
            False, n_steps_det, "detached")

    def pack(traces, key):
        return np.stack([t[key] for t in traces])

    out = dict(
        mode=mode, lo=lo, hi=hi, n_slots=n_slots, T=T, lr=lr,
        n_groups=n_groups, gidx=gidx,
        n_target=n_target,
        b_true=b_true, a_true=a_true, k1_true=k1_true,
        b_pert=b_pert, a_pert=a_pert, k1_pert=k1_pert,
        sb_pert=sb_pert, sa_pert=sa_pert,
        loss_score=np.asarray(loss_s), loss_detached=np.asarray(loss_d),
        times_score=np.asarray(times_s), times_detached=np.asarray(times_d),
        wall_score=wall_s, wall_detached=wall_d)
    if fit_a:
        out["trace_log_sa"] = pack(tr_s, "log_sa")
        out["det_trace_log_sa"] = pack(tr_d, "log_sa")
    if fit_b:
        out["trace_log_sb"] = pack(tr_s, "log_sb")
        out["det_trace_log_sb"] = pack(tr_d, "log_sb")
    if "k1" in params_s:
        out["trace_k1"] = pack(tr_s, "k1")
        out["det_trace_k1"] = pack(tr_d, "k1")
    np.savez(out_path, **out)
    print(f"saved {out_path}", flush=True)

    # summary: Polyak average over the last 30% of the trace (suppresses
    # the zero-drift gradient-noise walk of the weakly-constrained params)
    tail = max(1, int(0.3 * len(tr_s)))
    if mode == "k1":
        k1_fit = pack(tr_s, "k1")[-tail:].mean()
        k1_unc = pack(tr_s, "k1")[-tail:].std()
        k1_det = pack(tr_d, "k1")[-tail:].mean()
        print(f"k1: truth {k1_true:.4f}, perturbed {k1_pert:.4f}, "
              f"score-fit {k1_fit:.4f}+-{k1_unc:.4f}, "
              f"detached-fit {k1_det:.4f}", flush=True)
        return
    sa_fit = np.exp(pack(tr_s, "log_sa")[-tail:].mean(axis=0))
    sa_unc = np.exp(pack(tr_s, "log_sa")[-tail:]).std(axis=0)
    if fit_b:
        sb_fit = np.exp(pack(tr_s, "log_sb")[-tail:].mean(axis=0))
        sb_unc = np.exp(pack(tr_s, "log_sb")[-tail:]).std(axis=0)
        print("group  sb_pert -> sb_fit (truth 1.0)   sa_pert -> sa_fit")
        for g in range(n_groups):
            print(f"  [{g}] {sb_pert[g]:.3f} -> {sb_fit[g]:.3f}"
                  f"+-{sb_unc[g]:.3f}    {sa_pert[g]:.3f} -> "
                  f"{sa_fit[g]:.3f}+-{sa_unc[g]:.3f}")
        print("rel-RMS b scales: pert "
              f"{np.sqrt(np.mean((sb_pert-1)**2)):.4f} -> "
              f"fit {np.sqrt(np.mean((sb_fit-1)**2)):.4f}", flush=True)
    else:
        worst = np.argsort(-np.abs(sa_pert - 1.0))[:8]
        print("per-layer a_dust scales (8 largest perturbations):")
        for g in worst:
            print(f"  layer {lo+g:3d}: {sa_pert[g]:.3f} -> "
                  f"{sa_fit[g]:.3f}+-{sa_unc[g]:.3f}  (truth 1.000)")
    print("rel-RMS a scales: pert "
          f"{np.sqrt(np.mean((sa_pert-1)**2)):.4f} -> "
          f"fit {np.sqrt(np.mean((sa_fit-1)**2)):.4f}", flush=True)


if __name__ == "__main__":
    main()
