"""Multi-host bootstrap: one SPMD job replaces the reference's ZMQ
client/server stack (private/clsim/I3CLSimServer.cxx:81-370).

On a multi-host cluster each host runs the SAME program;
`initialize_distributed` wires the hosts into one JAX runtime (coordinator
discovery via standard cluster env vars, explicit arguments for bare-metal
setups) and `global_photon_mesh` builds the photon-sharded mesh over every
device of every host.  Hit histograms / ice-parameter gradients then combine
with a single psum -- there is no message-routing layer to maintain and no
M:N batching handshake: the mesh IS the fan-out.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np

from .mesh import PHOTON_AXIS, make_mesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed for a multi-host run.

    With no arguments, relies on JAX's cluster auto-detection
    (COORDINATOR_ADDRESS, SLURM, Open MPI); pass explicit values for
    bare-metal clusters.  Returns True when a multi-process runtime was initialized,
    False for single-process runs (harmless no-op, so the same script works
    on one host and on a pod).
    """
    explicit = coordinator_address is not None
    auto = any(v in os.environ for v in (
        "COORDINATOR_ADDRESS", "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE"))
    if not explicit and not auto:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def global_photon_mesh(axis: str = PHOTON_AXIS):
    """Photon-sharded mesh over every device of every host (call after
    initialize_distributed)."""
    return make_mesh(jax.devices(), axis=axis)


def process_step_slice(n_total_slots: int) -> slice:
    """The slot range this host must materialize when feeding a globally
    sharded StepBatch (hosts feed only their local shard -- the bounded-
    queue backpressure role of the reference's per-client step bunches)."""
    n_proc = jax.process_count()
    if n_total_slots % n_proc:
        raise ValueError(f"{n_total_slots} slots not divisible by "
                         f"{n_proc} processes")
    per = n_total_slots // n_proc
    i = jax.process_index()
    return slice(i * per, (i + 1) * per)
