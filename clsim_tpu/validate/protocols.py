"""Pinned-seed workloads of the engine-vs-oracle protocols (VALIDATION.md):
the BASELINE correctness configs #1-#4, shared by tests/test_oracle.py,
scripts/validate_oracle.py and chip_smoke.py.

Each returns (medium, geo, spectra, cfg, steps) with numpy steps; the
flasher config also returns the oracle's per-source-type spectra.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..geometry import hexagonal_geometry
from ..medium.anisotropy import AnisotropyParams
from ..medium.functions import DEFAULT_ICE_REF_INDEX
from ..medium.properties import make_homogeneous_ice
from ..medium.tilt import TiltParams
from ..ops.spectrum import make_cherenkov_spectrum, stack_spectra
from ..types import PropagationConfig, StepBatch


N_STEPS = 4096
PHOTONS_PER_STEP = 24


def cascade_workload(tilt=True, aniso=True, bias=False):
    """Config #1: cascade-like isotropic steps through a layered medium with
    tilt and anisotropy; `bias` turns the production wavelength bias on
    (config #4)."""
    r = np.random.default_rng(5)
    medium = make_homogeneous_ice(n_layers=14, z_start=-350.0,
                                  layer_height=50.0)
    medium = medium._replace(
        b400=jnp.asarray(0.015 + 0.03 * r.random(14), jnp.float32),
        a_dust400=jnp.asarray(0.003 + 0.006 * r.random(14), jnp.float32),
        delta_tau=jnp.asarray(0.5 + r.random(14), jnp.float32))
    if aniso:
        medium = medium._replace(anisotropy=AnisotropyParams(
            azimuth=jnp.float32(3.9), mag_along=jnp.float32(0.04),
            mag_perp=jnp.float32(-0.08), enabled=True))
    if tilt:
        nd, nz = 4, 9
        medium = medium._replace(tilt=TiltParams(
            distances=jnp.asarray([-900.0, -250.0, 350.0, 1000.0]),
            first_z=jnp.float32(-450.0),
            z_spacing=jnp.float32(110.0),
            z_corrections=jnp.asarray(
                15.0 * r.standard_normal((nd, nz)), jnp.float32),
            azimuth_cos=jnp.float32(np.cos(3.93)),
            azimuth_sin=jnp.float32(np.sin(3.93)),
            enabled=True))

    geo = hexagonal_geometry(n_rings=1, string_spacing=70.0,
                             doms_per_string=12, dom_spacing=16.0,
                             z_top=90.0, oversize=9.0)
    if bias:
        # a real wavelength bias so the weight-unfolding contract (saveHit
        # weight = step.weight / bias, propagation_kernel.c.cl:370) is
        # exercised; note 1/bias is heavy-tailed at the spectrum edges, so
        # tests on biased runs must use robust (quantile) statistics
        from ..hits.acceptance import icecube_dom_acceptance
        acc = icecube_dom_acceptance(dom_radius=geo.om_radius * geo.oversize,
                                     efficiency=1.0)
        nb = np.asarray(acc.values).shape[0]
        bias_x = float(acc.first_x) + float(acc.dx) * np.arange(nb)
        bias_y = np.asarray(acc.values)
        spectra = stack_spectra([make_cherenkov_spectrum(
            DEFAULT_ICE_REF_INDEX, 265.0, 675.0,
            bias_wlen_nm=bias_x, bias_values=bias_y)])
    else:
        spectra = stack_spectra([make_cherenkov_spectrum(
            DEFAULT_ICE_REF_INDEX, 265.0, 675.0)])
    cfg = PropagationConfig(
        n_slots=N_STEPS, pancake_factor=4.0, hist_t_min=0.0,
        hist_t_max=2000.0, hist_n_bins=50, max_layer_steps=8,
        max_segment_m=120.0, stop_on_detection=True)

    rr = np.random.default_rng(77)
    costh = rr.uniform(-1, 1, N_STEPS)
    sinth = np.sqrt(1 - costh ** 2)
    phi = rr.uniform(0, 2 * np.pi, N_STEPS)
    steps = StepBatch(
        x=np.full(N_STEPS, 9.0, np.float32),
        y=np.full(N_STEPS, -4.0, np.float32),
        z=np.full(N_STEPS, 13.0, np.float32),
        t=np.zeros(N_STEPS, np.float32),
        dir_x=(sinth * np.cos(phi)).astype(np.float32),
        dir_y=(sinth * np.sin(phi)).astype(np.float32),
        dir_z=costh.astype(np.float32),
        length=np.full(N_STEPS, 3.0, np.float32),
        beta=np.ones(N_STEPS, np.float32),
        num_photons=np.full(N_STEPS, PHOTONS_PER_STEP, np.int32),
        weight=np.ones(N_STEPS, np.float32),
        identifier=np.zeros(N_STEPS, np.int32),
        source_type=np.zeros(N_STEPS, np.int32))
    return medium, geo, spectra, cfg, steps


def muon_workload():
    """Config #2: muon-track steps through config #1's layered medium with
    tilt and anisotropy on (the protocol's parsed spice_lea tables are not
    part of this repository)."""
    medium = cascade_workload()[0]
    geo = hexagonal_geometry(n_rings=1, string_spacing=70.0,
                             doms_per_string=12, dom_spacing=16.0,
                             z_top=90.0, oversize=9.0)
    spectra = stack_spectra([make_cherenkov_spectrum(
        DEFAULT_ICE_REF_INDEX, float(medium.min_wlen),
        float(medium.max_wlen))])
    cfg = PropagationConfig(
        n_slots=N_STEPS, pancake_factor=4.0, hist_t_min=0.0,
        hist_t_max=2000.0, hist_n_bins=50, max_layer_steps=8,
        max_segment_m=80.0, stop_on_detection=True)
    # one muon track crossing the array: every step row is a slice of the
    # same track (spawn positions sample uniformly along `length`)
    d = np.array([0.25, 0.10, 0.96])
    d = d / np.linalg.norm(d)
    steps = StepBatch(
        x=np.full(N_STEPS, -30.0, np.float32),
        y=np.full(N_STEPS, -12.0, np.float32),
        z=np.full(N_STEPS, -120.0, np.float32),
        t=np.zeros(N_STEPS, np.float32),
        dir_x=np.full(N_STEPS, d[0], np.float32),
        dir_y=np.full(N_STEPS, d[1], np.float32),
        dir_z=np.full(N_STEPS, d[2], np.float32),
        length=np.full(N_STEPS, 250.0, np.float32),
        beta=np.ones(N_STEPS, np.float32),
        num_photons=np.full(N_STEPS, PHOTONS_PER_STEP, np.int32),
        weight=np.ones(N_STEPS, np.float32),
        identifier=np.zeros(N_STEPS, np.int32),
        source_type=np.zeros(N_STEPS, np.int32))
    return medium, geo, spectra, cfg, steps


def flasher_workload():
    """Config #3: LED flasher pulses (source_type=1 on a stacked 405 nm
    spectrum; flasher photons keep the smeared pulse direction)."""
    from ..sources.flasher import led_spectrum
    medium, geo, _, cfg, _ = cascade_workload()
    cher = make_cherenkov_spectrum(DEFAULT_ICE_REF_INDEX, 265.0, 675.0)
    led = led_spectrum(405)
    spectra = stack_spectra([cher, led])
    rr = np.random.default_rng(99)
    # horizontally-pointing LED with 10-degree Gaussian smearing
    phi = 0.3 + 0.17 * rr.standard_normal(N_STEPS)
    theta = np.pi / 2 + 0.17 * rr.standard_normal(N_STEPS)
    steps = StepBatch(
        x=np.full(N_STEPS, 2.0, np.float32),
        y=np.full(N_STEPS, 35.2, np.float32),   # next to a ring-1 string
        z=np.full(N_STEPS, 20.0, np.float32),
        t=np.zeros(N_STEPS, np.float32),
        dir_x=(np.sin(theta) * np.cos(phi)).astype(np.float32),
        dir_y=(np.sin(theta) * np.sin(phi)).astype(np.float32),
        dir_z=np.cos(theta).astype(np.float32),
        length=np.zeros(N_STEPS, np.float32),
        beta=np.ones(N_STEPS, np.float32),
        num_photons=np.full(N_STEPS, PHOTONS_PER_STEP, np.int32),
        weight=np.ones(N_STEPS, np.float32),
        identifier=np.zeros(N_STEPS, np.int32),
        source_type=np.ones(N_STEPS, np.int32))
    oracle_spectra = [(np.asarray(cher.x), np.asarray(cher.beta)),
                      (np.asarray(led.x), np.asarray(led.beta))]
    return medium, geo, spectra, cfg, steps, oracle_spectra
