"""Device-time measurement helpers.

The pipeline's completion-gap estimate (parallel/pipeline.py) equals device
time only when the in-flight queue is saturated.  This module provides the
cross-checks: a jax.profiler trace around a propagation call (the trace
holds the device timeline), and a saturated-queue wall-clock estimate.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler.trace wrapper; the trace (device and host timelines)
    lands under `logdir` for TensorBoard / xprof or
    jax.profiler.ProfileData."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def profile_device_time(fn: Callable[[], object], reps: int = 5,
                        warmup: int = 1) -> dict:
    """Estimate a jitted call's device execution time by saturating the
    dispatch queue: launch `reps` calls back-to-back and divide the
    span between the first and last completion -- with async dispatch the
    host-side launch gap vanishes and the measurement converges to device
    time (the CL_PROFILING_COMMAND_START/END role,
    I3CLSimStepToPhotonConverterOpenCL.cxx:1092-1135).

    `fn` must return a pytree of jax arrays; completion is awaited with
    `jax.block_until_ready`.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter()
    out = None
    for _ in range(reps - 1):
        out = fn()
    jax.block_until_ready(out)
    last = time.perf_counter()
    per_call_saturated = (last - first) / max(reps - 1, 1)
    return {
        "device_time_s": per_call_saturated,
        "first_call_s": first - t0,
        "queue_saturated": reps > 1,
    }
