"""Event-level orchestration: multi-event pipelining with asynchronous
device dispatch.

This replaces the reference's threaded event loop
(I3CLSimModule/I3CLSimClientModule + feeder/harvester threads + the bounded
I3CLSimQueue backpressure, SURVEY.md sections 2.6/2.9): instead of host
threads shuttling bunches between queues, JAX's asynchronous dispatch IS the
double buffering -- the host enqueues the next slot batch while the device
still executes the previous one, and results are only synchronized when
harvested.  Events stay attributed through the step identifier exactly like
the reference's particleCache (identifier -> (event, particle) bookkeeping,
I3CLSimModule.cxx:1039-1296).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..sources.particles import FlasherPulse, Particle
from ..sources.ppc import assign_steps_to_slots
from ..types import PropagationConfig, StepBatch
from ..util.stats import RunStatistics


@dataclasses.dataclass
class EventResult:
    event_id: int
    hist: np.ndarray
    n_generated: float
    n_hits: float
    weight_hits: float
    per_particle: Dict[int, float]   # identifier -> generated photons


class EventPipeline:
    """Processes a stream of events (particle lists) with bounded in-flight
    device work.

    `max_in_flight` plays the role of the reference's bounded queue depth
    (queueToOpenCL_ size 5, …OpenCL.cxx:77): the host generates steps for up
    to that many batches ahead of the device.
    """

    def __init__(self, simulation, max_in_flight: int = 4):
        self.sim = simulation
        self.max_in_flight = max_in_flight
        self.stats = RunStatistics()

    def process(self, events: Sequence[Sequence[Particle]], seed: int
                ) -> List[EventResult]:
        """Run all events; returns per-event results in submission order
        (the FlushFrameCache contract: results reassembled per event via
        identifiers, pushed in original order)."""
        rng = np.random.default_rng(seed)
        sim = self.sim

        # identifier partitioning: event k's particles get identifiers
        # k * STRIDE + i so hits re-associate to (event, particle)
        STRIDE = 65536
        prepared = []   # (event_id, slot_batches, per_particle_counts)
        for ev_id, particles in enumerate(events):
            batches = []
            per_particle = {}
            for i, p in enumerate(particles):
                ident = ev_id * STRIDE + i
                if isinstance(p, FlasherPulse):
                    bs = sim.flasher_generator.convert(p, ident, rng)
                else:
                    bs = sim.step_generator.convert(p, ident, rng)
                for b in bs:
                    per_particle[ident] = per_particle.get(ident, 0) + int(
                        np.asarray(b.num_photons).sum())
                batches.extend(bs)
            if batches:
                merged = StepBatch.concatenate(
                    [StepBatch(*[np.asarray(f) for f in b]) for b in batches])
                slot_batches = assign_steps_to_slots(
                    StepBatch(*[np.asarray(f) for f in merged]),
                    sim.config.n_slots)
            else:
                slot_batches = []
            prepared.append((ev_id, slot_batches, per_particle))

        # asynchronous dispatch with bounded in-flight futures: the device
        # works on batch k while the host prepares/enqueues k+1..k+depth
        from ..propagate.dispatch import propagate_auto
        in_flight = []   # (event_id, result_future, host_t0)
        results: Dict[int, EventResult] = {}
        last_done = [None]   # completion time of the previous harvest

        def harvest(entry):
            ev_id, res, t0 = entry
            hist = np.asarray(res.hist)       # sync point
            now = time.perf_counter()
            host_t = now - t0
            # device-time estimate from consecutive completion gaps: with a
            # saturated in-flight queue the device runs back-to-back, so the
            # gap between this completion and max(previous completion,
            # submission) is the device execution span of THIS batch (the
            # role of CL_PROFILING_COMMAND_START/END in the reference,
            # I3CLSimStepToPhotonConverterOpenCL.cxx:1092-1135)
            floor_t = t0 if last_done[0] is None else max(last_done[0], t0)
            device_t = max(now - floor_t, 0.0)
            last_done[0] = now
            r = results.get(ev_id)
            if r is None:
                r = EventResult(event_id=ev_id, hist=hist,
                                n_generated=float(res.n_generated),
                                n_hits=float(res.n_hits),
                                weight_hits=float(res.weight_hits),
                                per_particle={})
                results[ev_id] = r
            else:
                r.hist = r.hist + hist
                r.n_generated += float(res.n_generated)
                r.n_hits += float(res.n_hits)
                r.weight_hits += float(res.weight_hits)
            self.stats.record(float(res.n_generated), float(res.n_hits),
                              float(res.weight_hits), device_t, host_t)

        key = jax.random.PRNGKey(seed)
        batch_counter = 0
        for ev_id, slot_batches, per_particle in prepared:
            results.setdefault(ev_id, EventResult(
                event_id=ev_id,
                hist=np.zeros((sim.geometry.n_doms, sim.config.hist_n_bins),
                              np.float32),
                n_generated=0.0, n_hits=0.0, weight_hits=0.0,
                per_particle=per_particle))
            results[ev_id].per_particle = per_particle
            for batch in slot_batches:
                b = StepBatch(*[jnp.asarray(f) for f in batch])
                bkey = jax.random.fold_in(key, batch_counter)
                batch_counter += 1
                t0 = time.perf_counter()
                res = propagate_auto(b, sim.medium, sim.geometry,
                                     sim.spectra, bkey, sim.config)
                in_flight.append((ev_id, res, t0))
                if len(in_flight) >= self.max_in_flight:
                    harvest(in_flight.pop(0))
        while in_flight:
            harvest(in_flight.pop(0))

        return [results[k] for k in sorted(results)]
