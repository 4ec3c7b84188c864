"""Core data batches (struct-of-arrays) and the static simulation config.

Equivalents of the reference's packed POD structs:
  * StepBatch  <-> I3CLSimStep   (public/clsim/I3CLSimStep.h:68-155)
  * PhotonBatch<-> I3CLSimPhoton (public/clsim/I3CLSimPhoton.h:194-210)

Where the reference bakes feature flags into generated OpenCL via #defines
(SAVE_ALL_PHOTONS, STOP_PHOTONS_ON_DETECTION, PANCAKE_FACTOR, ...;
propagation_kernel.c.cl:27-41), this package specializes jit compilation on
the static fields of PropagationConfig.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np


class StepBatch(NamedTuple):
    """A bunch of light-emitting Cherenkov steps, padded to a fixed size with
    dummy steps (num_photons == 0), exactly like the reference's bunching
    contract (I3CLSimStepStore.h:163-220)."""
    x: jnp.ndarray          # (S,) start position [m]
    y: jnp.ndarray
    z: jnp.ndarray
    t: jnp.ndarray          # (S,) start time [ns]
    dir_x: jnp.ndarray      # (S,) unit direction (cartesian; the reference
    dir_y: jnp.ndarray      #      stores theta/phi and converts on device)
    dir_z: jnp.ndarray
    length: jnp.ndarray     # (S,) step length [m]
    beta: jnp.ndarray       # (S,) particle speed / c
    num_photons: jnp.ndarray  # (S,) uint32 photons to spawn
    weight: jnp.ndarray     # (S,) statistical weight
    identifier: jnp.ndarray   # (S,) uint32 external id (frame/particle ref)
    source_type: jnp.ndarray  # (S,) uint8: 0=Cherenkov, >=1 flasher spectrum

    @property
    def n_steps(self):
        return self.x.shape[0]

    @staticmethod
    def concatenate(batches):
        return StepBatch(*[jnp.concatenate([getattr(b, f) for b in batches])
                           for f in StepBatch._fields])

    @staticmethod
    def empty(n: int):
        zf = np.zeros(n, np.float32)
        zi = np.zeros(n, np.int32)
        return StepBatch(x=zf, y=zf, z=zf, t=zf, dir_x=zf, dir_y=zf,
                         dir_z=np.ones(n, np.float32), length=zf,
                         beta=np.ones(n, np.float32), num_photons=zi,
                         weight=np.ones(n, np.float32), identifier=zi,
                         source_type=zi)

    def pad_to(self, n: int):
        """Pad with dummy (num_photons=0) steps to exactly n entries."""
        cur = self.n_steps
        if cur == n:
            return self
        if cur > n:
            raise ValueError(f"batch of {cur} does not fit into {n}")
        pad = n - cur

        def _pad(a, fill=0):
            return np.concatenate([np.asarray(a),
                                   np.full((pad,), fill, np.asarray(a).dtype)])

        return StepBatch(
            x=_pad(self.x), y=_pad(self.y), z=_pad(self.z), t=_pad(self.t),
            dir_x=_pad(self.dir_x), dir_y=_pad(self.dir_y), dir_z=_pad(self.dir_z, 1),
            length=_pad(self.length), beta=_pad(self.beta, 1),
            num_photons=_pad(self.num_photons), weight=_pad(self.weight, 1),
            identifier=_pad(self.identifier), source_type=_pad(self.source_type))


class PhotonBatch(NamedTuple):
    """Recorded photons at DOMs (fixed-capacity, validity-masked).

    Field-for-field the information content of I3CLSimPhoton: hit position is
    stored *relative to the hit DOM center* with pancaking undone
    (propagation_kernel.c.cl:337-363), direction as (theta, phi)."""
    valid: jnp.ndarray        # (P,) bool
    pos_x: jnp.ndarray        # (P,) position relative to DOM center [m]
    pos_y: jnp.ndarray
    pos_z: jnp.ndarray
    time: jnp.ndarray         # (P,) arrival time [ns]
    dir_theta: jnp.ndarray
    dir_phi: jnp.ndarray
    wavelength: jnp.ndarray   # (P,) [nm]
    cherenkov_dist: jnp.ndarray  # (P,) total path length [m]
    num_scatters: jnp.ndarray
    weight: jnp.ndarray
    identifier: jnp.ndarray
    string_id: jnp.ndarray
    om_id: jnp.ndarray
    start_x: jnp.ndarray      # photon emission point / time / direction
    start_y: jnp.ndarray
    start_z: jnp.ndarray
    start_time: jnp.ndarray
    start_theta: jnp.ndarray
    start_phi: jnp.ndarray
    group_velocity: jnp.ndarray  # [m/ns]
    dist_in_abs_lens: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class PropagationConfig:
    """Static (compile-time) propagation options.

    Mirrors the reference's kernel #define flags and converter options
    (public/clsim/I3CLSimStepToPhotonConverterOpenCL.h:78-255)."""
    n_slots: int = 8192            # parallel photon slots (work items)
    stop_on_detection: bool = True  # STOP_PHOTONS_ON_DETECTION
    save_photons: bool = False      # keep full photon records (parity mode)
    save_all_photons: bool = False  # SAVE_ALL_PHOTONS: record every photon at
                                    # its absorption point (no detector test)
    save_all_prescale: float = 1.0  # SAVE_ALL_PHOTONS_PRESCALE
    photon_capacity_per_slot: int = 8  # record ring size when save_photons
    photon_history_entries: int = 0 # SAVE_PHOTON_HISTORY: keep the last N
                                    # scatter positions + abs-length depths
                                    # per recorded photon (I3CLSimPhotonHistory;
                                    # kernel ring propagation_kernel.c.cl:452-455)
    pancake_factor: float = 1.0     # PANCAKE_FACTOR (DOM oversize flattening)
    dom_oversize: float = 1.0       # collision radius = R * oversize
    max_segment_m: float = 90.0     # segment cap; bounds the per-iteration
                                    # layer/DOM windows (fixed-trip form of
                                    # the unbounded SIMT walk)
    max_layer_steps: int = 16       # medium layers crossable per segment
    max_dom_layers: int = 8         # DOM z-layers checked per (segment,string)
    strings_per_photon: int = 2     # top-K candidate strings per segment
    collision_mode: str = "culled"  # "culled" | "bruteforce" (oracle/testing)
    estimator: str = "detect"       # "detect": faithful clsim accept/reject;
                                    # "expected": continuous-absorption
                                    # pass-through weights (differentiable)
    hit_compact_capacity: int = 0   # >0: top_k-compact hits before the
                                    # histogram scatter (fewer scatter
                                    # updates); 0 = full scatter
    fixed_abs_lens: float = 0.0     # >0: PROPAGATE_FOR_FIXED_NUMBER_OF_
                                    # ABSORPTION_LENGTHS (tabulator mode)
    # time histogram
    hist_t_min: float = 0.0         # [ns]
    hist_t_max: float = 6400.0
    hist_n_bins: int = 512
    soft_binning: bool = False      # linear-interp deposition (differentiable)
    # expected-estimator completeness: fold the DOM angular acceptance
    # polynomial (hole ice, GetIceCubeDOMAngularSensitivity.py:36-45) into
    # the deposited weight at propagation time, where the photon direction
    # is still known -- the record-free differentiable path then carries the
    # same angular factor the accept/reject path applies per photon
    # (I3PhotonToMCPEConverter.cxx:466-475).  Static tuple of poly coeffs
    # in cos(eta); None disables.
    expected_angular_poly: Optional[tuple] = None
    pmt_axis: tuple = (0.0, 0.0, -1.0)
    # Detached-sampling gradients (expected estimator only): stop_gradient
    # the trajectory geometry (segment lengths, hit distances, scattered
    # directions) so parameter gradients flow through the survival weights
    # and deposit times only.  Naive pathwise AD through a multiple-
    # scattering trajectory explodes exponentially with scatter count
    # (chaotic paths); detached sampling is stable and EXACT for
    # absorption-side parameters (the expected-estimator trajectory law
    # does not depend on them, up to the exp(-horizon) cutoff).  Scattering-
    # parameter gradients omit the sampling-score term unless
    # score_function=True adds it back (below).
    detach_trajectories: bool = True
    # Score-function (likelihood-ratio) correction for detached sampling
    # (expected estimator + detach_trajectories only): every deposit is
    # multiplied by exp(L - stop_grad(L)) where L is the photon's running
    # log-likelihood of its SAMPLED scatter events -- per segment the
    # no-scatter survival -int b_eff ds (traced coefficients, detached
    # geometry), per scatter the distance density log b_eff(end) and the
    # HG/Liu mixture angle density.  The primal is exactly unchanged
    # (exp(0) = 1); the engine backward then carries pathwise + score terms, an unbiased estimator
    # of d E[hist] / d(scattering params) including the discontinuous
    # hit/miss contribution detached-pathwise AD misses (round-3 review
    # item 3).  Tradeoff: the score term's variance grows with scatter
    # count (~31 events/photon on bench ice), so fits need larger photon
    # batches per step than the absorption-only detached estimator;
    # tests/test_diff.py::test_score_function_recovers_scattering_gradient
    # measures the bias/variance on the review workload.
    score_function: bool = False

    @property
    def hist_dt(self) -> float:
        return (self.hist_t_max - self.hist_t_min) / self.hist_n_bins
