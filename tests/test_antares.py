"""Antares sea-water medium tests (BASELINE config #4): tabulated absorption,
particulate scattering, Quan&Fry index, Petzold/Rayleigh phase function."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from clsim_tpu.geometry import build_geometry
from clsim_tpu.medium.antares import (ANTARES_ABS_LEN, RAYLEIGH_FRACTION,
                                      make_antares_water, petzold_angle_tables)
from clsim_tpu.ops.samplers import sample_interpolated_fast
from clsim_tpu.propagate.engine import propagate
from clsim_tpu.types import PropagationConfig
from test_engine import _beam_steps, _spectra


def test_water_medium_tables():
    m = make_antares_water()
    assert m.medium_kind == "water"
    assert m.n_layers == 1
    # absorption at 450nm: table value 54.945m at index (450-290)/10 = 16..
    inv = float(m.abs_coeffs(jnp.float32(470.0))[1])
    assert 1.0 / inv == pytest.approx(54.945, rel=1e-3)
    # scattering length at 550nm: Kopelevich 0.0075ppm -> 1/(0.0017+1.34*0.0075+0.312*0.0075*1)
    inv_s = float(m.scat_coeff(jnp.float32(550.0)))
    expected = 0.0017 + 1.34 * 0.0075 + 0.312 * 0.0075
    assert inv_s == pytest.approx(expected, rel=1e-3)
    # Quan&Fry phase index ~1.35 at 450nm (high pressure sea water)
    npz = float(m.phase_ref_index(450.0))
    assert 1.34 < npz < 1.37


def test_petzold_sampling_moments():
    ang, acu, dens = petzold_angle_tables()
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (100_000,)))
    theta = np.asarray(sample_interpolated_fast(
        jnp.asarray(ang), jnp.asarray(acu), jnp.asarray(dens),
        jnp.asarray(u)))
    cos = np.cos(theta)
    # Petzold VSF is strongly forward peaked: <cos> ~ 0.92
    assert 0.85 < cos.mean() < 0.97
    assert theta.min() >= 0.0 and theta.max() <= np.pi + 1e-3


def test_beam_attenuation_in_water():
    """Straight-line survival through water must follow the tabulated
    absorption at the sampled wavelength (validates the water branch of the
    layer walk)."""
    m = make_antares_water()
    # turn off scattering for the analytic check
    m = m._replace(water_scat_inv=jnp.full_like(m.water_scat_inv, 1e-9))
    d = 40.0
    geo = build_geometry([1], [1], [d], [0.0], [0.0], oversize=5.0)
    spectra = _spectra(mono_wlen=470.0)
    cfg = PropagationConfig(n_slots=256)
    steps = _beam_steps(cfg.n_slots, 32)
    res = propagate(steps, m, geo, spectra, jnp.asarray([0, 4], jnp.uint32), cfg)
    r_entry = d - geo.collision_radius
    inv = float(m.abs_coeffs(jnp.float32(470.0))[1])
    assert float(res.n_hits) / float(res.n_generated) == pytest.approx(
        np.exp(-r_entry * inv), rel=0.07)


def test_water_scattering_smoke():
    m = make_antares_water()
    d = 25.0
    geo = build_geometry([1], [1], [d], [0.0], [0.0], oversize=5.0)
    spectra = _spectra(mono_wlen=470.0)
    cfg = PropagationConfig(n_slots=512)
    steps = _beam_steps(cfg.n_slots, 16)
    res = propagate(steps, m, geo, spectra, jnp.asarray([0, 6], jnp.uint32), cfg)
    assert float(res.n_hits) > 0
    assert np.isfinite(np.asarray(res.hist)).all()


def test_antares_acceptance_table():
    """The km3 optics composition (GetAntaresOMAcceptance.py:240-291):
    effective area over the OM profile, zero at 290/300 nm (opaque gel),
    peaking in the blue."""
    from clsim_tpu.hits.acceptance import antares_om_acceptance
    from clsim_tpu.medium.functions import eval_table
    acc = antares_om_acceptance()
    vals = np.asarray(acc.values)
    assert vals.shape == (33,)
    assert vals[0] == 0.0 and vals[1] == 0.0      # 290 nm pad + dead gel bin
    assert 0.0 < vals.max() < 0.1                 # small PMT on a 17" sphere
    peak_wlen = 290.0 + 10.0 * vals.argmax()
    assert 380.0 <= peak_wlen <= 480.0
    v420 = float(eval_table(acc, jnp.asarray(420.0)))
    assert v420 == pytest.approx(vals.max(), rel=0.2)


def test_km3net_acceptance_variants():
    from clsim_tpu.hits.acceptance import km3net_dom_acceptance
    simple = np.asarray(km3net_dom_acceptance().values)
    wpd = np.asarray(km3net_dom_acceptance(wpd_qe=True).values)
    cone = np.asarray(km3net_dom_acceptance(with_winston_cone=True).values)
    assert simple.shape == wpd.shape == (33,)
    assert simple.max() == pytest.approx(0.9 * 0.32, rel=0.05)
    assert wpd.max() == pytest.approx(0.9 * 0.304, rel=0.05)
    np.testing.assert_allclose(cone, 2.0 * simple, rtol=1e-6)


def test_antares_angular_models():
    from clsim_tpu.hits.acceptance import antares_om_angular_sensitivity
    for name, head_on in [("Spring09", 0.9991), ("Genova", 1.0),
                          ("NIM", 0.9967), ("old", None)]:
        ang = antares_om_angular_sensitivity(name)
        v1 = float(ang(jnp.asarray(1.0)))
        if head_on is not None:
            assert v1 == pytest.approx(head_on, abs=0.02), name
        assert 0.0 < v1 <= 1.0
        # hard cutoff: zero below cos_min
        below = float(ang(jnp.asarray(ang.cos_min - 0.05)))
        assert below == 0.0, name
    with pytest.raises(ValueError):
        antares_om_angular_sensitivity("nope")


def test_antares_end_to_end_hits():
    """BASELINE config #4 carried to HITS: beam through Antares water onto a
    storey of OMs, photon records -> MCPEs with the Antares acceptance and
    angular curves (the GetAntaresOMAcceptance / ...AngularSensitivity
    wiring the reference applies in I3PhotonToMCPEConverter)."""
    import dataclasses
    from clsim_tpu.hits.acceptance import (antares_om_acceptance,
                                           antares_om_angular_sensitivity)
    from clsim_tpu.hits.mcpe import mcpes_to_numpy, sample_mcpes
    medium = make_antares_water()
    geo = build_geometry([0, 0, 1], [0, 1, 0], [40.0, 40.0, 40.0],
                         [0.0, 0.0, 6.0], [0.0, -12.0, 1.0], oversize=8.0)
    cfg = PropagationConfig(n_slots=512, pancake_factor=1.0,
                            hist_t_min=0.0, hist_t_max=1500.0,
                            hist_n_bins=50, max_layer_steps=4,
                            max_segment_m=60.0, save_photons=True,
                            photon_capacity_per_slot=4)
    spectra = _spectra()
    steps = _beam_steps(cfg.n_slots, 16)
    res = propagate(steps, medium, geo, spectra,
                    jnp.asarray([0, 9], jnp.uint32), cfg)
    assert float(res.n_hits) > 100
    mcpes = sample_mcpes(res.rec, res.rec_count, jax.random.PRNGKey(1),
                         antares_om_acceptance(),
                         antares_om_angular_sensitivity("Spring09"),
                         pmt_axis=(0.0, 0.0, -1.0))
    dom, t, ident = mcpes_to_numpy(mcpes)
    # the acceptance curves thin the photons but keep a real signal
    assert 0 < dom.shape[0] < float(res.n_hits)
    assert (t >= 0).all()
