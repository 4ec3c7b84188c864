"""Single propagation entry point for callers that hold an int seed or a key.

This mirrors the reference's single entry point
(I3CLSimStepToPhotonConverter::EnqueueSteps): callers hand over a slot batch
and a seed, and the engine (one jit specialization per PropagationConfig,
where the reference compiles one OpenCL program per option set,
private/opencl/I3CLSimStepToPhotonConverterOpenCL.cxx) serves it.
"""

from __future__ import annotations

from typing import Union

import jax.numpy as jnp

from ..geometry import DetectorGeometry
from ..medium.properties import MediumProperties
from ..ops.spectrum import SpectrumTable
from ..types import PropagationConfig, StepBatch
from .engine import PropagationResult, propagate


def propagate_auto(steps: StepBatch, medium: MediumProperties,
                   geo: DetectorGeometry, spectra: SpectrumTable,
                   key_or_seed: Union[int, jnp.ndarray],
                   cfg: PropagationConfig) -> PropagationResult:
    """propagate() for an int seed or a threefry key: an int seed s runs
    the stream of key [0, s]."""
    key = (jnp.asarray([0, key_or_seed], jnp.uint32)
           if isinstance(key_or_seed, int) else key_or_seed)
    return propagate(steps, medium, geo, spectra, key, cfg)
