"""High-level user API: the equivalent of the reference's tray segments
I3CLSimMakePhotons / I3CLSimMakeHits (python/traysegments/).

    sim = Simulation(medium=..., geometry=..., oversize=5.0)
    result = sim.simulate(particles, seed=1234)          # photons/histograms
    doms, times, ids = sim.simulate_hits(particles, 42)  # MCPEs

Wiring contract (I3CLSimMakePhotons.py:370-430, common.py setupDetector):
  * wavelength generation bias = DOM acceptance evaluated at
    radius R*oversize with efficiency = icemodel_eff * unshadowed * holeice
    peak * 1.35 * 1.01 (the DeepCore + safety margin headroom)
  * PPC parameterization converts particles to steps (photons_per_step=200)
  * pancake factor = oversize (DOM flattened perpendicular to photon travel)
  * MCPE conversion divides the bias back out via the saved weights
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .geometry import DetectorGeometry
from .hits.acceptance import (dom_angular_sensitivity, icecube_dom_acceptance,
                              HOLE_ICE_H2_50CM)
from .hits.mcpe import MCPEBatch, mcpes_to_numpy, sample_mcpes
from .medium.properties import MediumProperties
from .ops.spectrum import (WavelengthSpectrum, make_cherenkov_spectrum,
                           make_tabulated_spectrum, stack_spectra)
from .propagate.dispatch import propagate_auto
from .propagate.engine import PropagationResult, propagate
from .sources.particles import FlasherPulse, Particle
from .sources.flasher import FlasherStepGenerator, get_flasher_spectrum
from .sources.ppc import PPCStepGenerator, assign_steps_to_slots
from .types import PropagationConfig, StepBatch


class Simulation:
    """End-to-end photon simulation for one detector + medium configuration."""

    def __init__(self,
                 medium: MediumProperties,
                 geometry: DetectorGeometry,
                 config: Optional[PropagationConfig] = None,
                 unweighted_photons: bool = False,
                 unshadowed_fraction: float = 1.0,
                 hole_ice_peak: float = HOLE_ICE_H2_50CM["peak"],
                 photons_per_step: int = 200,
                 use_cascade_extension: bool = True,
                 flasher_spectra: Sequence[WavelengthSpectrum] = (),
                 mesh=None,
                 propagators: Sequence = None):
        self.medium = medium
        self.geometry = geometry
        cfg = config or PropagationConfig()
        if cfg.pancake_factor == 1.0 and geometry.oversize != 1.0:
            cfg = dataclasses.replace(cfg, pancake_factor=geometry.oversize)
        self.config = cfg
        self.mesh = mesh

        # static collision-approximation check: warn when the top-K
        # closest-string test can provably shadow hits on this geometry
        from .geometry import advise_strings_per_photon
        _, k_reason = advise_strings_per_photon(
            geometry, cfg.max_segment_m, cfg.strings_per_photon)
        if k_reason:
            import warnings
            warnings.warn(k_reason, UserWarning, stacklevel=2)

        # --- wavelength bias (common.py:191-229, I3CLSimMakePhotons.py:389-397)
        if unweighted_photons:
            bias_x = bias_y = None
        else:
            eff = (float(medium.efficiency) * unshadowed_fraction *
                   hole_ice_peak * 1.35 * 1.01)
            acc = icecube_dom_acceptance(
                dom_radius=geometry.om_radius * geometry.oversize,
                efficiency=eff)
            nb = acc.values.shape[0]
            bias_x = np.asarray(acc.first_x) + np.asarray(acc.dx) * np.arange(nb)
            bias_y = np.asarray(acc.values)
        self._bias_x, self._bias_y = bias_x, bias_y

        cherenkov = make_cherenkov_spectrum(
            medium.ref_index, medium.min_wlen, medium.max_wlen,
            bias_wlen_nm=bias_x, bias_values=bias_y)
        all_spectra = [cherenkov]
        for fs in flasher_spectra:
            all_spectra.append(fs)
        self.spectra = stack_spectra(all_spectra)

        self.step_generator = PPCStepGenerator(
            medium, cherenkov, photons_per_step=photons_per_step,
            use_cascade_extension=use_cascade_extension)
        self.flasher_generator = FlasherStepGenerator(cherenkov)

        # conversion queue: propagator plugins (Geant4/PROPOSAL seam;
        # muon slicing by default) + parameterization matcher list
        from .sources.convert import (MuonSlicerPropagator, SourceConverter,
                                      default_parameterizations)
        if propagators is None:
            propagators = [MuonSlicerPropagator()]
        self.source_converter = SourceConverter(
            default_parameterizations(self.step_generator,
                                      self.flasher_generator),
            propagators=propagators)

        # MCPE acceptance: evaluated at the *true* DOM radius; dividing the
        # bias (oversized-radius acceptance) back out of the weights leaves
        # the residual ratio <= 1 (I3CLSimMakeHitsFromPhotons.py wiring)
        self.wlen_acceptance = icecube_dom_acceptance(
            dom_radius=geometry.om_radius * geometry.oversize, efficiency=1.0)
        self.angular_coeffs = dom_angular_sensitivity()

        self._propagate = None
        if mesh is not None:
            # scale-out: the reference fans steps out to its converters
            # (I3CLSimServer.cxx:163-370); here one SPMD program shards the
            # slots over the mesh and psums the histograms
            from .parallel.mesh import make_sharded_propagate
            self._propagate = make_sharded_propagate(mesh, self.config)

    # ------------------------------------------------------------------
    def steps_from_particles(self, particles: Sequence[Particle],
                             rng: np.random.Generator) -> List[StepBatch]:
        """Light sources -> step batches through the conversion queue:
        propagator plugins first (secondaries re-enqueued), then the
        parameterization matcher list (sources/convert.py; the
        I3CLSimLightSourceToStepConverterAsync worker semantics)."""
        batches = self.source_converter.convert(
            [(p, ident) for ident, p in enumerate(particles)], rng)
        if not batches:
            return []
        merged = StepBatch.concatenate(
            [StepBatch(*[jnp.asarray(f) for f in b]) for b in batches])
        n_slots = self.config.n_slots
        if self.mesh is not None:
            n_slots *= self.mesh.devices.size
        return assign_steps_to_slots(
            StepBatch(*[np.asarray(f) for f in merged]), n_slots)

    def run_steps(self, slot_batches: List[StepBatch], seed: int):
        """Propagate pre-assigned slot batches; accumulates over batches."""
        key = jax.random.PRNGKey(seed)
        total = None
        for i, batch in enumerate(slot_batches):
            bkey = jax.random.fold_in(key, i)
            batch = StepBatch(*[jnp.asarray(f) for f in batch])
            if self._propagate is not None:
                from .parallel.mesh import shard_steps
                batch = shard_steps(batch, self.mesh)
                res = self._propagate(batch, self.medium, self.geometry,
                                      self.spectra, bkey)
            else:
                res = propagate_auto(batch, self.medium, self.geometry,
                                     self.spectra, bkey, self.config)
            if total is None:
                total = res
            else:
                total = PropagationResult(
                    hist=total.hist + res.hist,
                    n_generated=total.n_generated + res.n_generated,
                    n_hits=total.n_hits + res.n_hits,
                    weight_hits=total.weight_hits + res.weight_hits,
                    n_iterations=total.n_iterations + res.n_iterations,
                    rec_count=res.rec_count, rec=res.rec)
        return total

    def simulate(self, particles: Sequence[Particle], seed: int
                 ) -> Optional[PropagationResult]:
        """Particles -> propagation result (per-DOM hit-time histograms and,
        in save_photons mode, photon records).  The I3CLSimMakePhotons
        equivalent."""
        rng = np.random.default_rng(seed)
        slot_batches = self.steps_from_particles(particles, rng)
        if not slot_batches:
            return None
        return self.run_steps(slot_batches, seed)

    def simulate_hits(self, particles: Sequence[Particle], seed: int,
                      dom_efficiency: float = 1.0,
                      per_dom_efficiency=None,
                      merge_window_ns: Optional[float] = None):
        """Particles -> (dom_indices, times, identifiers) MCPE arrays or,
        with a merge window, (dom, time, npe, identifier).  The
        I3CLSimMakeHits equivalent (requires save_photons=True config).

        `per_dom_efficiency` is an optional (n_doms,) calibration vector
        (RDE x SPE compensation, I3PhotonToMCPEConverter.cxx:340-387);
        `merge_window_ns` enables the reference's optional hit
        time-merging (…cxx:520+)."""
        if not self.config.save_photons:
            raise ValueError("simulate_hits requires config.save_photons=True")
        res = self.simulate(particles, seed)
        if res is None:
            return (np.zeros(0, np.int32), np.zeros(0, np.float32),
                    np.zeros(0, np.int32))
        if self.config.pancake_factor == 1.0 and not                 self.config.save_all_photons:
            # spherical-DOM sanity check (I3PhotonToMCPEConverter.cxx:415-455)
            from .hits.mcpe import check_photon_positions
            check_photon_positions(res.rec, res.rec_count,
                                   self.geometry.collision_radius,
                                   self.config.pancake_factor)
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x4d435045)
        mcpes = sample_mcpes(res.rec, res.rec_count, key,
                             self.wlen_acceptance, self.angular_coeffs,
                             efficiency=dom_efficiency,
                             dom_efficiency=per_dom_efficiency)
        dom, t, ident = mcpes_to_numpy(mcpes)
        if merge_window_ns is not None:
            from .hits.mcpe import merge_mcpes
            return merge_mcpes(dom, t, ident, merge_window_ns)
        return dom, t, ident

    # -- two-phase flow (MakePhotons -> file -> MakeHitsFromPhotons,
    #    python/traysegments/I3CLSimMakeHitsFromPhotons.py:55) -----------
    def simulate_photons(self, particles: Sequence[Particle], seed: int,
                         save_path=None):
        """Particles -> PhotonBatch with detector (string_id, om_id) pairs
        remapped from flat device indices on download
        (I3CLSimStepToPhotonConverterOpenCL.cxx:1563-1614).  Optionally
        persists to `save_path` (npz) — the I3CLSimMakePhotons half."""
        if not self.config.save_photons:
            raise ValueError(
                "simulate_photons requires config.save_photons=True")
        from .hits.photons import records_to_photon_batch, save_photons_npz
        res = self.simulate(particles, seed)
        if res is None:
            raise ValueError("no light sources produced steps")
        batch = records_to_photon_batch(res.rec, res.rec_count, self.geometry)
        if save_path is not None:
            save_photons_npz(save_path, batch)
        return batch

    def simulate_hits_from_photons(self, photons, seed: int,
                                   dom_efficiency: float = 1.0,
                                   per_dom_efficiency=None,
                                   merge_window_ns: Optional[float] = None):
        """PhotonBatch (or npz path) -> MCPE arrays: the
        I3CLSimMakeHitsFromPhotons half, runnable later / elsewhere against
        saved photon records."""
        from .hits.mcpe import merge_mcpes, sample_mcpes_from_batch
        from .hits.photons import load_photons_npz, photon_batch_dom_index
        if isinstance(photons, (str, bytes)) or hasattr(photons, "__fspath__"):
            photons = load_photons_npz(photons)
        dom_index = photon_batch_dom_index(photons, self.geometry)
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x4d435045)
        mcpes = sample_mcpes_from_batch(
            photons, dom_index, key, self.wlen_acceptance,
            self.angular_coeffs, efficiency=dom_efficiency,
            dom_efficiency=per_dom_efficiency)
        dom, t, ident = mcpes_to_numpy(mcpes)
        if merge_window_ns is not None:
            return merge_mcpes(dom, t, ident, merge_window_ns)
        return dom, t, ident
