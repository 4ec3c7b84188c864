"""Subprocess worker for the 2-process jax.distributed test
(test_parallel.py::test_bootstrap_two_process_psum).

Run as:  python tests/dist_worker.py PORT RANK OUT.npz
  RANK 0/1: one of two distributed processes (2 local CPU devices each;
            4 global devices), wired by bootstrap.initialize_distributed
            -- the MAIN branch of bootstrap.py, which the reference
            exercises with real processes in
            resources/tests/testCLSimServer.py:26-42.
  RANK -1:  single-process truth run with 4 local devices (identical
            global mesh shape, so per-shard RNG streams match exactly).

Each process materializes ONLY its local step slice
(bootstrap.process_step_slice) and the psum'd histogram must agree with
the single-process run.
"""

import os
import sys

PORT, RANK, OUT = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                           + ("2" if RANK >= 0 else "4"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402


def main():
    from clsim_tpu.geometry import single_string_geometry
    from clsim_tpu.medium.properties import make_homogeneous_ice
    from clsim_tpu.medium.functions import DEFAULT_ICE_REF_INDEX
    from clsim_tpu.ops.spectrum import make_cherenkov_spectrum, stack_spectra
    from clsim_tpu.parallel import bootstrap
    from clsim_tpu.parallel.mesh import PHOTON_AXIS, make_sharded_propagate
    from clsim_tpu.types import PropagationConfig, StepBatch

    if RANK >= 0:
        ok = bootstrap.initialize_distributed(
            coordinator_address=f"localhost:{PORT}",
            num_processes=2, process_id=RANK)
        assert ok, "initialize_distributed must take its main branch"
        assert jax.process_count() == 2
    else:
        # scrub the cluster auto-detect vars so the truth run takes the
        # single-process branch
        for v in ("COORDINATOR_ADDRESS", "SLURM_JOB_ID",
                  "OMPI_COMM_WORLD_SIZE"):
            os.environ.pop(v, None)
        assert bootstrap.initialize_distributed() is False  # no-op branch

    mesh = bootstrap.global_photon_mesh()
    n_dev = int(mesh.devices.size)
    assert n_dev == 4, n_dev

    medium = make_homogeneous_ice(b400=0.05, a_dust400=0.01)
    geo = single_string_geometry(n_doms=8, spacing=17.0, x=10.0,
                                 z_top=60.0, oversize=16.0)
    spectra = stack_spectra([make_cherenkov_spectrum(
        DEFAULT_ICE_REF_INDEX, 265.0, 675.0)])
    per_dev = 32
    cfg = PropagationConfig(n_slots=per_dev)
    n_global = per_dev * n_dev

    # deterministic beam workload, built identically on every process
    r = np.random.default_rng(77)
    phi = r.uniform(0, 2 * np.pi, n_global)
    dz = r.uniform(-0.3, 0.3, n_global)
    dxy = np.sqrt(1.0 - dz ** 2)
    steps_np = StepBatch(
        x=np.zeros(n_global, np.float32), y=np.zeros(n_global, np.float32),
        z=np.full(n_global, -20.0, np.float32),
        t=np.zeros(n_global, np.float32),
        dir_x=(dxy * np.cos(phi)).astype(np.float32),
        dir_y=(dxy * np.sin(phi)).astype(np.float32),
        dir_z=dz.astype(np.float32),
        length=np.full(n_global, 1.0, np.float32),
        beta=np.ones(n_global, np.float32),
        num_photons=np.full(n_global, 64, np.int32),
        weight=np.ones(n_global, np.float32),
        identifier=np.zeros(n_global, np.int32),
        source_type=np.zeros(n_global, np.int32))

    # each process feeds ONLY its local slot slice
    sl = bootstrap.process_step_slice(n_global)
    sharding = NamedSharding(mesh, P(PHOTON_AXIS))
    steps = StepBatch(*[
        jax.make_array_from_process_local_data(
            sharding, np.asarray(f)[sl], (n_global,) + np.asarray(f).shape[1:])
        for f in steps_np])

    run = make_sharded_propagate(mesh, cfg)
    res = run(steps, medium, geo, spectra, jnp.asarray([0, 55], jnp.uint32))
    hist = np.asarray(jax.device_get(res.hist), np.float64)
    out = dict(hist=hist,
               n_generated=float(jax.device_get(res.n_generated)),
               n_hits=float(jax.device_get(res.n_hits)),
               process_count=jax.process_count())
    if RANK <= 0:
        np.savez(OUT, **out)
    print(f"rank {RANK} done: n_hits={out['n_hits']}", flush=True)


if __name__ == "__main__":
    main()
