"""Tabulator throughput benchmark.

Measures photons/s of table generation (the reference's TABULATE mode,
propagation_kernel.c.cl:540-785) on the current device with a
spice-width layered medium and the default spherical axes.

Division of labor: jitted propagation chunks emit the comb's nonzero
(bin, weight) entries and the host accumulates them with np.add.at
(tabulator/table.py).  The reference's GPU tabulator instead atomically
adds into a ~75M-bin table in device memory
(propagation_kernel.c.cl:296-304); whether a device-side scatter-add beats
the host accumulation on the GPU is not measured yet.  Table generation is
an offline, once-per-ice-model workload (the reference's tablemaker runs
it as cluster batch jobs, resources/docs/tabulator.rst).

    python scripts/bench_tabulator.py
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from clsim_tpu.medium.functions import DEFAULT_ICE_REF_INDEX
from clsim_tpu.ops.spectrum import make_cherenkov_spectrum, stack_spectra
from clsim_tpu.tabulator.table import make_reference_source, tabulate
from clsim_tpu.types import PropagationConfig, StepBatch
from clsim_tpu.util.runtime import device_summary, enable_compile_cache
from clsim_tpu.workloads import layered_ice


def main():
    enable_compile_cache()
    on_cpu = jax.devices()[0].platform == "cpu"
    n_slots = int(os.environ.get("BENCH_SLOTS", 512 if on_cpu else 65536))
    pps = int(os.environ.get("BENCH_PHOTONS_PER_SLOT", 4 if on_cpu else 32))
    reps = int(os.environ.get("BENCH_REPS", 1 if on_cpu else 2))

    medium = layered_ice()
    spectra = stack_spectra([make_cherenkov_spectrum(
        DEFAULT_ICE_REF_INDEX, medium.min_wlen, medium.max_wlen)])
    source = make_reference_source(0.0, 0.0, 0.0, 0.0, np.pi / 2, 0.0)
    cfg = PropagationConfig(n_slots=n_slots, max_layer_steps=4,
                            max_segment_m=35.0)

    rng0 = np.random.default_rng(3)
    n = n_slots
    costh = rng0.uniform(-1, 1, n)
    sinth = np.sqrt(1 - costh ** 2)
    phi = rng0.uniform(0, 2 * np.pi, n)
    steps = StepBatch(
        x=np.zeros(n, np.float32), y=np.zeros(n, np.float32),
        z=np.zeros(n, np.float32), t=np.zeros(n, np.float32),
        dir_x=(sinth * np.cos(phi)).astype(np.float32),
        dir_y=(sinth * np.sin(phi)).astype(np.float32),
        dir_z=costh.astype(np.float32),
        length=np.full(n, 1e-3, np.float32),
        beta=np.ones(n, np.float32),
        num_photons=np.full(n, pps, np.int32),
        weight=np.ones(n, np.float32),
        identifier=np.zeros(n, np.int32),
        source_type=np.zeros(n, np.int32))

    def run(seed):
        # tabulate accumulates on the host, so its result is complete
        return tabulate([steps], medium, spectra, source, seed=seed, cfg=cfg)

    run(1)  # compile + warm
    t0 = time.perf_counter()
    for r in range(reps):
        run(2 + r)
    dt = (time.perf_counter() - t0) / reps
    rate = n_slots * pps / dt
    print(f"tabulator: {n_slots} slots x {pps} photons in {dt:.2f} s "
          f"= {rate:.3e} photons/s "
          f"on {device_summary()}")


if __name__ == "__main__":
    main()
