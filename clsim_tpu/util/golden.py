"""Golden-histogram validation protocol (BASELINE configs #1-#3).

The reference validates physics by running identical events through clsim and
through PPC with pinned RNG sequences and comparing DOM occupancy + timing
distributions (resources/scripts/compareToPPC*/ -- SURVEY.md section 4.3).
The OpenCL reference cannot run in this environment, so the analogous
contract here is:

  * three pinned-seed workloads mirroring BASELINE.json configs #1-#3
    (cascade / muon through SPICE layered ice / LED flasher),
  * their per-DOM hit-time histograms frozen as committed .npz goldens
    (scripts/make_golden.py),
  * tests/test_golden.py re-runs them on every change and requires the
    L1 histogram distance stay below 0.1% of the total weight -- any physics
    change that shifts timing or occupancy fails loudly, exactly like the
    reference's frozen-RNG PPC comparison.

Goldens are generated on the CPU backend (deterministic threefry + float32).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

GOLDEN_SEED = 20260818
REFERENCE_ICE = "/root/reference/resources/ice/spice_lea"


def _sim_cascade():
    """Config #1: 1 TeV e- cascade, PPC-parameterized steps, homogeneous
    2-layer ice, small string detector (BASELINE.json configs[0])."""
    import jax.numpy as jnp
    from ..api import Simulation
    from ..geometry import single_string_geometry
    from ..medium.properties import make_homogeneous_ice
    from ..sources.particles import Particle, ParticleType
    from ..types import PropagationConfig

    medium = make_homogeneous_ice(b400=0.04, a_dust400=0.006)
    geo = single_string_geometry(n_doms=24, spacing=17.0, x=25.0,
                                 z_top=200.0, oversize=5.0)
    sim = Simulation(medium=medium, geometry=geo,
                     config=PropagationConfig(n_slots=4096, hist_t_min=0.0,
                                              hist_t_max=3200.0,
                                              hist_n_bins=400))
    cascade = Particle.cascade(ParticleType.EMinus, pos=(0.0, 0.0, 0.0),
                               time=0.0, energy=1000.0, zenith=np.pi / 2,
                               azimuth=np.pi)
    return sim, [cascade]


def _sim_muon():
    """Config #2: muon track through full SPICE layered South Pole ice
    (tilt + anisotropy), DOM oversize 5 (BASELINE.json configs[1])."""
    from ..api import Simulation
    from ..geometry import hexagonal_geometry
    from ..medium.ice_parser import parse_ppc_ice_model
    from ..medium.properties import make_homogeneous_ice
    from ..sources.particles import Particle, ParticleType
    from ..types import PropagationConfig

    if os.path.isdir(REFERENCE_ICE):
        medium, _ = parse_ppc_ice_model(REFERENCE_ICE)
    else:  # pragma: no cover - reference ice not present
        medium = make_homogeneous_ice(n_layers=171, z_start=-855.0,
                                      layer_height=10.0)
    geo = hexagonal_geometry(n_rings=1, string_spacing=125.0,
                             doms_per_string=30, dom_spacing=17.0,
                             z_top=250.0, oversize=5.0)
    sim = Simulation(medium=medium, geometry=geo,
                     config=PropagationConfig(n_slots=4096, hist_t_min=0.0,
                                              hist_t_max=6400.0,
                                              hist_n_bins=400))
    # travels toward -x, slightly downward, passing ~2m from the center
    # string (a bare muon yields only ~50 biased photons/m, so the golden
    # workload needs a close, long track for meaningful hit statistics)
    zen, azi = np.pi / 2.05, 0.0
    muon = Particle(ptype=ParticleType.MuMinus, x=260.0, y=2.0, z=0.0,
                    time=0.0, energy=500.0,
                    dir_x=-np.sin(zen) * np.cos(azi),
                    dir_y=-np.sin(zen) * np.sin(azi),
                    dir_z=-np.cos(zen), length=600.0)
    return sim, [muon]


def _sim_flasher():
    """Config #3: LED flasher run, 405nm spectrum, angular/time smearing,
    DOM acceptance bias folded in (BASELINE.json configs[2])."""
    from ..api import Simulation
    from ..geometry import single_string_geometry
    from ..medium.properties import make_homogeneous_ice
    from ..sources.flasher import led_spectrum
    from ..sources.particles import FlasherPulse
    from ..types import PropagationConfig

    medium = make_homogeneous_ice(b400=0.04, a_dust400=0.006)
    geo = single_string_geometry(n_doms=24, spacing=17.0, x=40.0,
                                 z_top=200.0, oversize=5.0)
    sim = Simulation(medium=medium, geometry=geo,
                     config=PropagationConfig(n_slots=4096, hist_t_min=0.0,
                                              hist_t_max=3200.0,
                                              hist_n_bins=400),
                     flasher_spectra=[led_spectrum(405)])
    pulse = FlasherPulse(x=0.0, y=0.0, z=-30.0, time=0.0,
                         dir_x=1.0, dir_y=0.0, dir_z=0.0,
                         num_photons_no_bias=5e5,
                         angular_smear_polar=0.2, angular_smear_azimuthal=0.3,
                         pulse_width=5.0, spectrum_index=1)
    return sim, [pulse]


CONFIGS = {
    "config1_cascade": _sim_cascade,
    "config2_muon_spice": _sim_muon,
    "config3_flasher": _sim_flasher,
}


def run_config(name: str) -> Dict[str, np.ndarray]:
    sim, sources = CONFIGS[name]()
    res = sim.simulate(sources, seed=GOLDEN_SEED)
    return {
        "hist": np.asarray(res.hist, np.float64),
        "n_generated": np.asarray(float(res.n_generated)),
        "n_hits": np.asarray(float(res.n_hits)),
        "weight_hits": np.asarray(float(res.weight_hits)),
    }


def compare_to_golden(result: Dict[str, np.ndarray],
                      golden: Dict[str, np.ndarray],
                      l1_tol: float = 1e-3) -> None:
    """Assert the allclose contract: exact photon counts, L1 histogram
    distance below l1_tol of total weight."""
    assert float(result["n_generated"]) == float(golden["n_generated"]), (
        "photon count changed: step generation or RNG stream drifted")
    h, g = result["hist"].ravel(), golden["hist"].ravel()
    assert h.shape == g.shape
    l1 = np.abs(h - g).sum()
    total = g.sum()
    assert l1 <= l1_tol * total + 1e-9, (
        f"histogram L1 drift {l1:.4g} vs total {total:.4g}")
