"""Gradient tests of the engine's differentiable path (expected estimator,
bounded reverse-differentiable loop): engine AD against finite differences
of the same forward on the same key (primal/gradient consistency, the
BASELINE gradient contract), and the score-function correction for
scattering parameters."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from clsim_tpu.geometry import hexagonal_geometry
from clsim_tpu.medium.functions import DEFAULT_ICE_REF_INDEX
from clsim_tpu.medium.properties import make_homogeneous_ice
from clsim_tpu.ops.spectrum import make_cherenkov_spectrum, stack_spectra
from clsim_tpu.propagate.engine import propagate
from clsim_tpu.types import PropagationConfig, StepBatch

N = 512
T = 12


def _setup():
    medium = make_homogeneous_ice(n_layers=4, z_start=-100.0,
                                  layer_height=50.0,
                                  b400=0.03, a_dust400=0.01)
    geo = hexagonal_geometry(n_rings=1, string_spacing=60.0,
                             doms_per_string=8, dom_spacing=15.0,
                             z_top=60.0, oversize=8.0)
    spectra = stack_spectra([make_cherenkov_spectrum(
        DEFAULT_ICE_REF_INDEX, 265.0, 675.0)])
    cfg = PropagationConfig(n_slots=N, estimator="expected",
                            soft_binning=True, fixed_abs_lens=10.0,
                            pancake_factor=4.0, hist_t_min=0.0,
                            hist_t_max=1600.0, hist_n_bins=32,
                            max_layer_steps=4, max_segment_m=80.0)
    rr = np.random.default_rng(5)
    costh = rr.uniform(-1, 1, N)
    sinth = np.sqrt(1 - costh ** 2)
    phi = rr.uniform(0, 2 * np.pi, N)
    steps = StepBatch(
        x=np.full(N, 5.0, np.float32), y=np.full(N, -2.0, np.float32),
        z=np.full(N, 8.0, np.float32), t=np.zeros(N, np.float32),
        dir_x=(sinth * np.cos(phi)).astype(np.float32),
        dir_y=(sinth * np.sin(phi)).astype(np.float32),
        dir_z=costh.astype(np.float32),
        length=np.full(N, 1.0, np.float32),
        beta=np.ones(N, np.float32),
        num_photons=np.full(N, 2, np.int32),
        weight=np.ones(N, np.float32),
        identifier=np.zeros(N, np.int32),
        source_type=np.zeros(N, np.int32))
    steps = StepBatch(*[jnp.asarray(f) for f in steps])
    return medium, geo, spectra, cfg, steps


def _hist(steps, medium, geo, spectra, key, cfg, n_iterations):
    return propagate(steps, medium, geo, spectra, key, cfg,
                     max_iterations=n_iterations).hist


def test_diff_gradient_matches_engine_ad_and_fd():
    medium, geo, spectra, cfg, steps = _setup()
    key = jnp.asarray([0, 9], jnp.uint32)
    # random fixed projection makes the scalar sensitive to shape, not just
    # the total
    proj = jnp.asarray(np.random.default_rng(2).random(
        (geo.n_doms, cfg.hist_n_bins)), jnp.float32)

    def loss(a_dust):
        m = medium._replace(a_dust400=jnp.full(4, a_dust, jnp.float32))
        return jnp.sum(_hist(steps, m, geo, spectra, key, cfg, T) * proj)

    a0 = 0.01
    g = float(jax.grad(loss)(jnp.float32(a0)))
    eps = 2e-4
    fd = (float(loss(jnp.float32(a0 + eps)))
          - float(loss(jnp.float32(a0 - eps)))) / (2 * eps)
    assert g == pytest.approx(fd, rel=0.02)
    assert g < 0.0   # more dust -> fewer weighted hits


def test_diff_scattering_gradient_bias_bounded():
    """DEFAULT (score_function=False) scattering-parameter gradients use
    detached sampling with the score term omitted -- a known bias, bounded
    here (sign + order of magnitude vs the fixed-stream FD).  The unbiased
    estimator is cfg.score_function=True, validated quantitatively in
    test_score_function_recovers_scattering_gradient; this test pins the
    cheap default's behavior.  (Note: the single-stream FD below has a
    per-stream sd of ~580 on a mean of ~140 -- it is a bound witness, not
    a truth value; see the score test for a converged comparison.)"""
    medium, geo, spectra, cfg, steps = _setup()
    key = jnp.asarray([0, 9], jnp.uint32)

    def loss(b400):
        m = medium._replace(b400=jnp.full(4, b400, jnp.float32))
        return jnp.sum(_hist(steps, m, geo, spectra, key, cfg, T))

    b0 = 0.03
    g_ad = float(jax.grad(loss)(jnp.float32(b0)))
    eps = 1e-3
    fd = (float(loss(jnp.float32(b0 + eps)))
          - float(loss(jnp.float32(b0 - eps)))) / (2 * eps)
    assert abs(fd) > 0.0
    # Measured bias decomposition on this workload (documented, not tuned):
    #   FD (full, incl. discontinuous hit/miss flips)  ~ 878
    #   detached pathwise AD (shipped estimator)       ~  62
    #   full pathwise AD (detach off, chaotic paths)   ~ 3.5
    # Scattering-parameter gradients are dominated by the DISCONTINUOUS
    # term (whether a perturbed trajectory intersects a DOM at all) that no
    # pathwise estimator carries; detached sampling still under-estimates
    # but keeps the right sign and is numerically stable, while full
    # pathwise AD through the chaotic trajectory is WORSE (derivative
    # cancellation), justifying detach_trajectories=True as the default.
    assert np.sign(g_ad) == np.sign(fd), (g_ad, fd)
    assert abs(g_ad / fd) < 1.0, (g_ad, fd)

    # regression: full-pathwise mode must at least be FINITE -- it NaN'd
    # before the where-guards in rotations.py / the frac division
    cfg_full = dataclasses.replace(cfg, detach_trajectories=False)

    def loss_full(b400):
        m = medium._replace(b400=jnp.full(4, b400, jnp.float32))
        return jnp.sum(_hist(steps, m, geo, spectra, key, cfg_full, T))

    g_full = float(jax.grad(loss_full)(jnp.float32(b0)))
    assert np.isfinite(g_full), g_full


def test_diff_absorption_gradient_exact_under_detachment():
    """Absorption-side parameters do not influence the (detached)
    trajectory law at all, so the detached gradient is EXACT -- FD at tight
    tolerance (complements the bounded-bias scattering test)."""
    medium, geo, spectra, cfg, steps = _setup()
    key = jnp.asarray([0, 9], jnp.uint32)

    def loss(abs_d):
        m = medium._replace(abs_D=jnp.float32(abs_d))
        return jnp.sum(_hist(steps, m, geo, spectra, key, cfg, T))

    d0 = float(medium.abs_D)
    g_ad = float(jax.grad(loss)(jnp.float32(d0)))
    eps = d0 * 1e-3
    fd = (float(loss(jnp.float32(d0 + eps)))
          - float(loss(jnp.float32(d0 - eps)))) / (2 * eps)
    assert g_ad == pytest.approx(fd, rel=0.03)


def _beam_workload(n=2048):
    """Pencil beam at a single DOM 40 m out: the cleanest scattering-
    gradient workload (more scattering = fewer direct hits, a large clean
    negative d/db400 dominated by trajectory-law sensitivity that detached
    pathwise AD cannot see at all)."""
    from clsim_tpu.geometry import build_geometry
    medium = make_homogeneous_ice(n_layers=4, z_start=-200.0,
                                  layer_height=100.0,
                                  b400=0.02, a_dust400=0.005)
    geo = build_geometry([0], [0], [40.0], [0.0], [0.0], oversize=8.0)
    spectra = stack_spectra([make_cherenkov_spectrum(
        DEFAULT_ICE_REF_INDEX, 265.0, 675.0)])
    cfg = PropagationConfig(n_slots=n, estimator="expected",
                            soft_binning=True, fixed_abs_lens=12.0,
                            pancake_factor=1.0, hist_t_min=0.0,
                            hist_t_max=1600.0, hist_n_bins=32,
                            max_layer_steps=4, max_segment_m=80.0)
    steps = StepBatch(
        x=jnp.zeros(n), y=jnp.zeros(n), z=jnp.zeros(n), t=jnp.zeros(n),
        dir_x=jnp.full(n, 0.99995), dir_y=jnp.zeros(n),
        dir_z=jnp.full(n, 0.01),
        length=jnp.zeros(n), beta=jnp.ones(n),
        num_photons=jnp.full(n, 4, jnp.int32), weight=jnp.ones(n),
        identifier=jnp.zeros(n, jnp.int32),
        source_type=jnp.ones(n, jnp.int32))   # flasher-type: no cone
    return medium, geo, spectra, cfg, steps


def test_score_function_recovers_scattering_gradient():
    """cfg.score_function adds the likelihood-ratio (score) term for the
    sampled scatter distances/angles; the gradient must then match finite
    differences of the SAME function (round-3 review item 3).

    Measured on this workload at n=8192 x 8 streams (see the types.py
    docstring): FD truth -105.0k +- 1.0k, score AD -101.3k +- 0.7k (3.5%
    agreement), detached AD +29.6k (WRONG SIGN: the trajectory-law term
    dominates and detached pathwise AD misses it).  Variance tradeoff: the
    score estimator's per-stream sd is ~2k here vs ~0.2k detached -- the
    correction costs ~10x variance, the price of an unbiased
    trajectory-law term.  The test runs a smaller n with stream averaging
    and a tolerance covering both estimators' noise."""
    medium, geo, spectra, cfg, steps = _beam_workload(n=4096)
    cfg_s = dataclasses.replace(cfg, score_function=True)
    Tb = 6
    b0 = jnp.float32(0.02)

    def loss(b, c, key):
        m = medium._replace(b400=jnp.full(4, b, jnp.float32))
        return jnp.sum(_hist(steps, m, geo, spectra, key, c, Tb))

    # eps = 2e-3 (10% of b0): FD variance scales ~1/eps and the secant was
    # measured flat between eps 1e-3 and 2e-3, so the larger eps buys
    # noise, not curvature bias
    eps = 2e-3
    g_sc, g_de, fd = [], [], []
    for k in range(5):
        key = jnp.asarray([0, 700 + k], jnp.uint32)
        g_sc.append(float(jax.grad(loss)(b0, cfg_s, key)))
        g_de.append(float(jax.grad(loss)(b0, cfg, key)))
        fd.append((float(loss(b0 + eps, cfg_s, key))
                   - float(loss(b0 - eps, cfg_s, key))) / (2 * eps))
    m_sc, m_de, m_fd = (np.mean(g_sc), np.mean(g_de), np.mean(fd))
    assert m_fd < 0.0, m_fd
    # score must carry the FD sign and land within tens of percent
    assert np.sign(m_sc) == np.sign(m_fd)
    assert abs(m_sc / m_fd - 1.0) < 0.35, (m_sc, m_fd)
    # and must beat detached by an order of magnitude in recovered fraction
    assert abs(m_sc - m_fd) < 0.4 * abs(m_de - m_fd), (m_sc, m_de, m_fd)
    # primal is exactly unchanged by the flag (exp(0) == 1)
    key = jnp.asarray([0, 700], jnp.uint32)
    assert float(loss(b0, cfg_s, key)) == float(loss(b0, cfg, key))


def test_score_function_keeps_absorption_gradient():
    """The score correction must not disturb the (already near-exact)
    absorption-parameter channel: score-mode AD == plain-mode AD for
    a_dust400 on the same stream."""
    medium, geo, spectra, cfg, steps = _beam_workload(n=1024)
    cfg_s = dataclasses.replace(cfg, score_function=True)
    key = jnp.asarray([0, 11], jnp.uint32)

    def loss(ad, c):
        m = medium._replace(a_dust400=jnp.full(4, ad, jnp.float32))
        return jnp.sum(_hist(steps, m, geo, spectra, key, c, 6))

    a0 = jnp.float32(0.005)
    g_plain = float(jax.grad(loss)(a0, cfg))
    g_score = float(jax.grad(loss)(a0, cfg_s))
    assert g_score == pytest.approx(g_plain, rel=1e-5)
