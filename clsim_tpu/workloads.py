"""Benchmark-scale detector, ice and light-source workloads shared by the
entry points (bench.py, chip_smoke.py, scripts/).

The reference benchmark (resources/scripts/benchmark.py:10-30, 297-340)
runs 40 TeV e- cascades through spice_lea ice and the real 86-string
geometry.  The spice_lea tables and the GCD file are not part of this
repository, so these functions stand in for them at the same widths: a
171-layer x 10 m layered ice table and an 86-string IceCube-like layout.
Everything is built from fixed seeds on the host.
"""

from __future__ import annotations

import numpy as np

from .geometry import DetectorGeometry, build_geometry, hexagonal_geometry
from .hits.acceptance import icecube_dom_acceptance
from .medium.functions import DEFAULT_ICE_REF_INDEX
from .medium.properties import MediumProperties, make_homogeneous_ice
from .ops.spectrum import SpectrumTable, make_cherenkov_spectrum, stack_spectra
from .types import PropagationConfig, StepBatch


def layered_ice() -> MediumProperties:
    """171 layers x 10 m from z = -855 m: spice_lea's table width."""
    return make_homogeneous_ice(n_layers=171, z_start=-855.0,
                                layer_height=10.0)


def icecube86_geometry(oversize: float = 5.0) -> DetectorGeometry:
    """IceCube-like 86-string layout: 78 main-array strings on a perturbed
    125 m hexagonal lattice (60 DOMs, 17 m spacing) plus 8 DeepCore infill
    strings (denser 7 m ladder at a different depth grid).  Exercises the
    non-uniform-z collision path the regular hex61 geometry skips (the
    reference benchmark runs the real 86-string GCD; this mirrors its
    irregular structure without shipping detector data)."""
    rng = np.random.default_rng(86)
    centers = [(0.0, 0.0)]
    ring = 1
    while len(centers) < 78:
        for k in range(6 * ring):
            side = k // ring
            step = k % ring
            a0 = np.pi / 3.0 * side
            a1 = np.pi / 3.0 * (side + 2)
            x = ring * np.cos(a0) + step * np.cos(a1)
            y = ring * np.sin(a0) + step * np.sin(a1)
            centers.append((x * 125.0, y * 125.0))
            if len(centers) >= 78:
                break
        ring += 1
    centers = np.asarray(centers) + rng.normal(0.0, 2.0, (78, 2))

    sids, oids, xs, ys, zs = [], [], [], [], []
    for si, (cx, cy) in enumerate(centers):
        for d in range(60):
            sids.append(si)
            oids.append(d)
            xs.append(cx)
            ys.append(cy)
            zs.append(500.0 - d * 17.0)
    # DeepCore: 8 strings within ~72 m of the center, 50 DOMs at 7 m
    # starting deeper (below the dust layer)
    for k in range(8):
        a = 2 * np.pi * k / 8.0
        cx = 72.0 * np.cos(a) if k else 30.0
        cy = 72.0 * np.sin(a) if k else 10.0
        for d in range(50):
            sids.append(78 + k)
            oids.append(d)
            xs.append(cx)
            ys.append(cy)
            zs.append(-150.0 - d * 7.0)
    return build_geometry(sids, oids, xs, ys, zs, oversize=oversize)


def biased_cherenkov_spectra(medium: MediumProperties,
                             geo: DetectorGeometry) -> SpectrumTable:
    """Cherenkov spectrum biased by the DOM acceptance at the oversized
    radius (the production wavelength bias, I3CLSimMakePhotons.py:389-397)."""
    acc = icecube_dom_acceptance(dom_radius=geo.om_radius * geo.oversize,
                                 efficiency=1.0)
    nb = np.asarray(acc.values).shape[0]
    bias_x = float(acc.first_x) + float(acc.dx) * np.arange(nb)
    return stack_spectra([make_cherenkov_spectrum(
        DEFAULT_ICE_REF_INDEX, medium.min_wlen, medium.max_wlen,
        bias_wlen_nm=bias_x, bias_values=np.asarray(acc.values))])


def cascade_step_cloud(n_slots: int, photons_per_slot: int) -> StepBatch:
    """One cascade-like step per slot near the detector center: the PPC
    cascade angular profile around (0.6, 0, 0.8) and a Gamma longitudinal
    profile (the benchmark's 40 TeV e- cascade at the array center).
    Numpy steps from a fixed seed."""
    from .sources.ppc import _rotate_by_angle, sample_cascade_angles
    rng = np.random.default_rng(1234)
    n = n_slots
    c, s = sample_cascade_angles(rng, n)
    dx, dy, dz = _rotate_by_angle(c, s, np.full(n, 0.6), np.zeros(n),
                                  np.full(n, 0.8), rng.random(n))
    longi = 0.63 * rng.standard_gamma(4.5, n)
    return StepBatch(
        x=(longi * 0.6).astype(np.float32),
        y=np.zeros(n, np.float32),
        z=(longi * 0.8).astype(np.float32),
        t=np.zeros(n, np.float32),
        dir_x=dx.astype(np.float32), dir_y=dy.astype(np.float32),
        dir_z=dz.astype(np.float32),
        length=np.full(n, 1e-3, np.float32),
        beta=np.ones(n, np.float32),
        num_photons=np.full(n, photons_per_slot, np.int32),
        weight=np.ones(n, np.float32),
        identifier=np.zeros(n, np.int32),
        source_type=np.zeros(n, np.int32))


def fit_workload(n_slots: int):
    """The ice-fit workload of FIT.md: 19-string hex detector, one isotropic
    emission point per slot spread through the instrumented volume
    (z in [-450, 450] m), expected estimator with soft binning into
    128-bin per-DOM histograms.  Returns (medium, geo, spectra, cfg,
    steps) with numpy steps."""
    medium = layered_ice()
    geo = hexagonal_geometry(n_rings=2, string_spacing=125.0,
                             doms_per_string=60, dom_spacing=17.0,
                             z_top=500.0, oversize=5.0)
    spectra = biased_cherenkov_spectra(medium, geo)
    cfg = PropagationConfig(n_slots=n_slots, estimator="expected",
                            soft_binning=True, fixed_abs_lens=8.0,
                            pancake_factor=5.0, hist_t_min=0.0,
                            hist_t_max=3000.0, hist_n_bins=128,
                            max_layer_steps=4, max_segment_m=35.0)
    rr = np.random.default_rng(4242)
    n = n_slots
    costh = rr.uniform(-1, 1, n)
    sinth = np.sqrt(1 - costh ** 2)
    phi = rr.uniform(0, 2 * np.pi, n)
    r_xy = 220.0 * np.sqrt(rr.random(n))
    a_xy = rr.uniform(0, 2 * np.pi, n)
    steps = StepBatch(
        x=(r_xy * np.cos(a_xy)).astype(np.float32),
        y=(r_xy * np.sin(a_xy)).astype(np.float32),
        z=rr.uniform(-450.0, 450.0, n).astype(np.float32),
        t=np.zeros(n, np.float32),
        dir_x=(sinth * np.cos(phi)).astype(np.float32),
        dir_y=(sinth * np.sin(phi)).astype(np.float32),
        dir_z=costh.astype(np.float32),
        length=np.full(n, 1e-3, np.float32),
        beta=np.ones(n, np.float32),
        num_photons=np.ones(n, np.int32),
        weight=np.ones(n, np.float32),
        identifier=np.zeros(n, np.int32),
        source_type=np.zeros(n, np.int32))
    return medium, geo, spectra, cfg, steps
