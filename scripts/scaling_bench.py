"""Scaling-efficiency harness: photons/s vs device count on a mesh.

Measures the ">=90% scaling efficiency 1 device -> N" contract on the
devices JAX sees (the cards of one host, joined all to all by NVLink; for
several hosts run one process per host after
clsim_tpu.parallel.bootstrap.initialize_distributed()).  A rehearsal on
virtual CPU devices validates the sharded program and the harness only:
virtual devices share the host's cores, so their efficiency means nothing.

    python scripts/scaling_bench.py [max_devices] [slots_per_device]
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python scripts/scaling_bench.py 8 512      # rehearsal

Prints one JSON line: {"throughput_photons_per_s": {n: ...}, ...}
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main():
    args = sys.argv[1:]
    max_devices = int(args[0]) if args else len(jax.devices())
    slots_per_dev = int(args[1]) if len(args) > 1 else 512
    photons_per_slot = int(os.environ.get("SCALING_PHOTONS", "16"))

    from bench import build_workload
    from clsim_tpu.parallel.mesh import (make_mesh, make_sharded_propagate,
                                         shard_steps)
    from clsim_tpu.types import StepBatch
    from clsim_tpu.util.runtime import device_summary, enable_compile_cache

    enable_compile_cache()

    sizes = []
    n = 1
    while n <= max_devices:
        sizes.append(n)
        n *= 2

    throughput = {}
    for nd in sizes:
        devices = jax.devices()[:nd]
        mesh = make_mesh(np.asarray(devices))
        medium, geo, spectra, cfg, steps = build_workload(
            "hex61", slots_per_dev * nd, photons_per_slot)
        cfg = dataclasses.replace(cfg, n_slots=slots_per_dev)
        run = make_sharded_propagate(mesh, cfg)
        steps = shard_steps(StepBatch(*[jnp.asarray(f) for f in steps]),
                            mesh)
        key = jnp.asarray([0, 3], jnp.uint32)
        jax.block_until_ready(run(steps, medium, geo, spectra, key))
        t0 = time.perf_counter()
        reps = 2
        for r in range(reps):
            res = jax.block_until_ready(run(
                steps, medium, geo, spectra,
                jnp.asarray([0, 4 + r], jnp.uint32)))
        total_r = float(res.n_generated)
        dt = (time.perf_counter() - t0) / reps
        throughput[nd] = total_r / dt
        print(f"# {nd} devices: {throughput[nd]:.3e} photons/s "
              f"({total_r:.0f} photons, {dt*1e3:.1f} ms)", file=sys.stderr)

    base = throughput[sizes[0]] / sizes[0]
    eff = {n: throughput[n] / (n * base) for n in sizes}
    # analytic collective model: the sharded program's only collective is
    # the final histogram psum, a reduce-scatter + all-gather that moves
    # ~2 * (D-1)/D * hist_bytes per device; predicted efficiency is
    # compute / (compute + comm) at the link rate (NVLink on H100:
    # 450 GB/s each way, NVIDIA's data sheet)
    hist_bytes = float(geo.n_doms * cfg.hist_n_bins * 4)
    link_bw = float(os.environ.get("SCALING_LINK_BW", 4.5e11))
    compute_s = dt
    analytic = {}
    for ndev in (2, 4, 8):
        comm_s = 2.0 * (ndev - 1) / ndev * hist_bytes / link_bw
        analytic[ndev] = compute_s / (compute_s + comm_s)
    print(f"# analytic psum model: hist={hist_bytes/1e6:.2f} MB, "
          f"step compute ~{compute_s*1e3:.0f} ms -> predicted efficiency "
          + ", ".join(f"{n}d:{analytic[n]:.4f}" for n in analytic),
          file=sys.stderr)
    print(json.dumps({
        "metric": "scaling_efficiency",
        "throughput_photons_per_s": throughput,
        "efficiency_vs_1dev": eff,
        "value": eff[sizes[-1]],
        "unit": "fraction",
        "device": device_summary(),
        "analytic_psum_efficiency": analytic,
    }))


if __name__ == "__main__":
    main()
