"""Throughput benchmark: photons propagated per second on one device.

Replicates the semantics of the reference's resources/scripts/benchmark.py
(40 TeV-scale cascade workload, spice_lea-width layered ice,
stop-on-detection, DOM oversize 5) in three cells:

  hex61       61-string hexagonal detector, 200 photons per slot
  ic86        the 86-string IceCube-like detector, 200 photons per slot
  hex61_prod  hex61 at 1000 photons per slot (the reference benchmark's
              in-flight scale amortizes the slot drain tail)

Prints exactly one JSON line naming the device (platform, device_kind,
count and the card's nvidia-smi name and power limit) beside the rates.
Refuses to run anywhere but on a GPU unless JAX_PLATFORMS=cpu is set
explicitly, which runs a shrunken rehearsal whose rates are CPU rates.
"""

import json
import os
import sys
import time

import numpy as np


def build_workload(geo_name, n_slots, photons_per_slot):
    """Host-side (numpy) workload of one cell."""
    from clsim_tpu.geometry import hexagonal_geometry
    from clsim_tpu.types import PropagationConfig
    from clsim_tpu.workloads import (biased_cherenkov_spectra,
                                     cascade_step_cloud, icecube86_geometry,
                                     layered_ice)

    medium = layered_ice()
    if geo_name == "ic86":
        geo = icecube86_geometry(oversize=5.0)
    else:
        geo = hexagonal_geometry(n_rings=4, string_spacing=125.0,
                                 doms_per_string=60, dom_spacing=17.0,
                                 z_top=500.0, oversize=5.0)
    spectra = biased_cherenkov_spectra(medium, geo)

    # max_segment_m=35 with 4 layer steps: statistically identical physics
    # to the 90 m default (memoryless exponential truncation) with a
    # smaller walk window and collision reach per iteration
    seg = float(os.environ.get("BENCH_SEG", 35.0))
    cfg = PropagationConfig(n_slots=n_slots, pancake_factor=5.0,
                            hist_n_bins=512,
                            max_layer_steps=max(2, int(np.ceil(seg / 10.0))),
                            max_segment_m=seg,
                            hit_compact_capacity=4096)

    steps = cascade_step_cloud(n_slots, photons_per_slot)
    return medium, geo, spectra, cfg, steps


def main():
    import jax
    import jax.numpy as jnp

    from clsim_tpu.propagate.dispatch import propagate_auto
    from clsim_tpu.types import StepBatch
    from clsim_tpu.util.runtime import (card_name_and_power_limit,
                                        device_summary, enable_compile_cache)

    device = device_summary()
    rehearsal = os.environ.get("JAX_PLATFORMS") == "cpu"
    if device["platform"] != "gpu" and not rehearsal:
        sys.exit(f"bench: needs a GPU, JAX found {device['platform']!r} "
                 "(set JAX_PLATFORMS=cpu for a CPU rehearsal)")
    enable_compile_cache()
    card = "none (CPU rehearsal)" if rehearsal else card_name_and_power_limit()
    n_slots = int(os.environ.get("BENCH_SLOTS", 2048 if rehearsal else 262144))
    reps = 1 if rehearsal else 2
    # 200 photons/slot keeps the drain tail from dominating the rate;
    # the _prod cell runs 1000/slot
    pps = int(os.environ.get("BENCH_PHOTONS_PER_SLOT",
                             8 if rehearsal else 200))
    prod_pps = int(os.environ.get("BENCH_PROD_PHOTONS_PER_SLOT",
                                  40 if rehearsal else 1000))

    def measure(geo_name, photons_per_slot):
        medium, geo, spectra, cfg, steps = build_workload(
            geo_name, n_slots, photons_per_slot)
        steps_j = StepBatch(*[jnp.asarray(f) for f in steps])

        def run(seed):
            res = jax.block_until_ready(propagate_auto(
                steps_j, medium, geo, spectra, int(seed), cfg))
            return float(res.n_generated)

        t0 = time.perf_counter()
        run(99)
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        total = sum(run(100 + r) for r in range(reps))
        return total / (time.perf_counter() - t0), compile_s

    out = {"metric": "photons_propagated_per_s_per_chip",
           "unit": "photons/s", "device": device, "card": card,
           "n_slots": n_slots, "reps": reps}
    for cell, geo_name, p in (("hex61", "hex61", pps),
                              ("ic86", "ic86", pps),
                              ("hex61_prod", "hex61", prod_pps)):
        out[cell], out[f"{cell}_first_call_s"] = measure(geo_name, p)
        out[f"{cell}_photons_per_slot"] = p
        if not out[cell] > 0.0:
            raise RuntimeError(f"bench produced no throughput for {cell}")
    out["value"] = out["hex61"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
