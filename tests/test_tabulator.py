"""Photon-table (tabulator) tests: axis semantics, coordinate binning, and a
physics check of the direct-light peak position."""

import numpy as np
import pytest
import jax.numpy as jnp

from clsim_tpu.medium.properties import make_homogeneous_ice
from clsim_tpu.tabulator import (Axis, SphericalAxes, default_spherical_axes,
                                 make_reference_source, save_table_npz,
                                 tabulate)
from clsim_tpu.types import PropagationConfig
from test_engine import _beam_steps, _spectra


def test_axis_semantics():
    a = Axis(0.0, 100.0, 10, power=1)
    assert int(a.bin_index(jnp.float32(-5.0))) == 0      # underflow
    assert int(a.bin_index(jnp.float32(5.0))) == 1       # first bin
    assert int(a.bin_index(jnp.float32(95.0))) == 10
    assert int(a.bin_index(jnp.float32(150.0))) == 11    # overflow
    p = Axis(0.0, 100.0, 10, power=2)
    edges = p.bin_edges()
    assert edges[0] == 0.0 and edges[-1] == pytest.approx(100.0)
    # power-2 spacing clusters near 0
    assert edges[1] < 10.0


def test_spherical_axes_strides():
    ax = default_spherical_axes()
    assert ax.n_bins == np.prod(ax.shape)
    idx = ax.flat_index((jnp.float32(10.0), jnp.float32(90.0),
                         jnp.float32(0.0), jnp.float32(100.0)))
    assert 0 <= int(idx) < ax.n_bins


def test_tabulate_direct_light_peak():
    """A weak-scattering beam along +x must fill the cos(polar)~1... actually
    along the source direction: bins at small radius get direct light with
    near-zero residual time."""
    medium = make_homogeneous_ice(b400=0.005, a_dust400=0.01)
    spectra = _spectra()
    cfg = PropagationConfig(n_slots=128, max_segment_m=30.0,
                            max_layer_steps=6)
    steps = _beam_steps(cfg.n_slots, 4, direction=(1.0, 0.0, 0.0))
    source = make_reference_source(0.0, 0.0, 0.0, 0.0,
                                   zenith=np.pi / 2, azimuth=np.pi)  # +x
    axes = SphericalAxes([
        Axis(0.0, 200.0, 20, power=2),
        Axis(0.0, 180.0, 6),
        Axis(-1.0, 1.0, 10),
        Axis(0.0, 2000.0, 20, power=2),
    ])
    table = tabulate([steps], medium, spectra, source, seed=5, axes=axes,
                     cfg=cfg)
    vals = table.values
    assert vals.shape == axes.shape
    assert np.isfinite(vals).all()
    assert vals.sum() > 0
    # direct light: the on-axis cos(polar)=1 bins dominate over backward bins
    forward = vals[:, :, -2, :].sum()   # cos in last data bin (~1)
    backward = vals[:, :, 1, :].sum()   # cos near -1
    assert forward > 10 * backward
    # residual time of direct light is in the first time bin
    # (delay ~ 0 along the axis)
    r_slice = vals[1:-1, :, -2, 1:-1]
    t_profile = r_slice.sum(axis=(0, 1))
    assert t_profile.argmax() == 0


def test_save_table(tmp_path):
    medium = make_homogeneous_ice(b400=0.01, a_dust400=0.02)
    spectra = _spectra()
    cfg = PropagationConfig(n_slots=32, max_segment_m=30.0, max_layer_steps=6)
    steps = _beam_steps(cfg.n_slots, 2)
    source = make_reference_source(0, 0, 0, 0, np.pi / 2, np.pi)
    axes = SphericalAxes([Axis(0, 100, 10, 2), Axis(0, 180, 4),
                          Axis(-1, 1, 5), Axis(0, 1000, 10, 2)])
    table = tabulate([steps], medium, spectra, source, seed=1, axes=axes,
                     cfg=cfg)
    path = tmp_path / "table.npz"
    save_table_npz(table, str(path))
    loaded = np.load(path)
    np.testing.assert_array_equal(loaded["values"], table.values)


def test_cylindrical_axes_volumes_and_bounds():
    from clsim_tpu.tabulator import CylindricalAxes, default_cylindrical_axes
    ax = default_cylindrical_axes()
    assert ax.n_bins == np.prod(ax.shape)
    vol = ax.bin_volumes()
    assert vol.shape == (100, 36, 80)
    # analytic check of one cell: ((rho1^2-rho0^2)/2) * 2*dphi * dz
    e0 = ax.axes[0].bin_edges()
    dphi = np.pi / 36
    dz = 1600.0 / 80
    np.testing.assert_allclose(
        vol[3, 0, 0], (e0[4] ** 2 - e0[3] ** 2) / 2 * 2 * dphi * dz)
    # only the time bound terminates (Axes.cxx CylindricalAxes)
    assert bool(ax.out_of_bounds((jnp.float32(1e5), jnp.float32(0),
                                  jnp.float32(0), jnp.float32(0)))) is False
    assert bool(ax.out_of_bounds((jnp.float32(0), jnp.float32(0),
                                  jnp.float32(0), jnp.float32(1e9)))) is True


def test_tabulate_cylindrical_track():
    """An infinite-muon-style table: beam along +x, cylindrical axes; direct
    light concentrates at small rho and near-zero cone-residual time."""
    from clsim_tpu.tabulator import Axis, CylindricalAxes
    medium = make_homogeneous_ice(b400=0.005, a_dust400=0.01)
    spectra = _spectra()
    cfg = PropagationConfig(n_slots=128, max_segment_m=30.0,
                            max_layer_steps=6)
    steps = _beam_steps(cfg.n_slots, 4, direction=(1.0, 0.0, 0.0))
    source = make_reference_source(0.0, 0.0, 0.0, 0.0,
                                   zenith=np.pi / 2, azimuth=np.pi)  # +x
    axes = CylindricalAxes([
        Axis(0.0, 200.0, 20, power=2),
        Axis(0.0, np.pi, 6),
        Axis(-200.0, 200.0, 10),
        Axis(0.0, 2000.0, 20, power=2),
    ])
    table = tabulate([steps], medium, spectra, source, seed=5, axes=axes,
                     cfg=cfg)
    vals = table.values
    assert vals.shape == axes.shape
    assert np.isfinite(vals).all() and vals.sum() > 0
    # direct Cherenkov light sits at small rho with residual time ~ 0
    rho_profile = vals[1:-1, :, 1:-1, 1:-1].sum(axis=(1, 2, 3))
    assert rho_profile.argmax() < 5
    # the cone residual of a point source is r*(n_group - n_phase)/c > 0, so
    # the peak sits in an early (but not necessarily the first) power-2 bin
    t_profile = vals[1:-1, :, 1:-1, 1:-1].sum(axis=(0, 1, 2))
    assert t_profile.argmax() <= 3
    assert t_profile[:5].sum() > 10 * t_profile[10:].sum()


def test_fits_roundtrip(tmp_path):
    from clsim_tpu.tabulator import read_fits, save_table_fits
    from clsim_tpu.tabulator import Axis, SphericalAxes
    medium = make_homogeneous_ice(b400=0.01, a_dust400=0.02)
    spectra = _spectra()
    cfg = PropagationConfig(n_slots=32, max_segment_m=30.0, max_layer_steps=6)
    steps = _beam_steps(cfg.n_slots, 2)
    source = make_reference_source(0, 0, 0, 0, np.pi / 2, np.pi)
    axes = SphericalAxes([Axis(0, 100, 10, 2), Axis(0, 180, 4),
                          Axis(-1, 1, 5), Axis(0, 1000, 10, 2)])
    table = tabulate([steps], medium, spectra, source, seed=1, axes=axes,
                     cfg=cfg)
    path = str(tmp_path / "table.fits")
    save_table_fits(table, path)
    vals, edges, header, errors = read_fits(path)
    np.testing.assert_allclose(vals, table.values.astype(np.float32),
                               rtol=1e-6)
    assert len(edges) == 4
    np.testing.assert_allclose(edges[0], axes.axes[0].bin_edges())
    assert header["n_photons"] == pytest.approx(table.header["n_photons"])
    assert "n_group" in header and "n_phase" in header
    # file structure: 2880-byte blocks, SIMPLE first card
    raw = open(path, "rb").read()
    assert len(raw) % 2880 == 0
    assert raw[:6] == b"SIMPLE"


def test_impact_angle_axis():
    """TABULATE_IMPACT_ANGLE parity (spherical_coordinates.c.cl:27-31,64-75;
    propagation_kernel.c.cl:245-250): a 5th impact-cosine axis replaces the
    angular-acceptance weight; on-axis direct light has impact cosine near 1
    (the randomized receiver normal stays within asin(sqrt(u)) of the photon
    direction, which points along the emitter->impact vector)."""
    medium = make_homogeneous_ice(b400=0.005, a_dust400=0.01)
    spectra = _spectra()
    cfg = PropagationConfig(n_slots=128, max_segment_m=30.0,
                            max_layer_steps=6)
    steps = _beam_steps(cfg.n_slots, 4, direction=(1.0, 0.0, 0.0))
    source = make_reference_source(0.0, 0.0, 0.0, 0.0,
                                   zenith=np.pi / 2, azimuth=np.pi)  # +x
    axes5 = SphericalAxes([
        Axis(0.0, 200.0, 10, power=2),
        Axis(0.0, 180.0, 4),
        Axis(-1.0, 1.0, 6),
        Axis(0.0, 2000.0, 10, power=2),
        Axis(-1.0, 1.0, 8),
    ])
    assert axes5.impact_angle and axes5.n_dim == 5
    table = tabulate([steps], medium, spectra, source, seed=7, axes=axes5,
                     cfg=cfg)
    vals = table.values
    assert vals.shape == axes5.shape
    assert np.isfinite(vals).all() and vals.sum() > 0
    # impact-cosine marginal of the data bins: weighted toward cos=+1
    # (impact angle asin(sqrt(u)) has mean cos = 2/3 for isotropic receivers,
    # and direct on-axis light aligns dir with the emitter->impact vector)
    prof = vals[1:-1, :, 1:-1, 1:-1, 1:-1].sum(axis=(0, 1, 2, 3))
    centers = 0.5 * (np.linspace(-1, 1, 9)[:-1] + np.linspace(-1, 1, 9)[1:])
    mean_cos = (prof * centers).sum() / prof.sum()
    assert mean_cos > 0.4
    assert prof[-1] > prof[0]  # forward impacts dominate backward ones

    # the acceptance weight must be ABSENT with the 5th axis: total content
    # (unnormalized) exceeds the acceptance-weighted 4-axis table's total
    axes4 = SphericalAxes(axes5.axes[:4])
    table4 = tabulate([steps], medium, spectra, source, seed=7, axes=axes4,
                      cfg=cfg)
    vol = axes4.bin_volumes()
    dom_area = np.pi * table4.header["dom_radius"] ** 2
    renorm4 = (table4.values[1:-1, 1:-1, 1:-1] *
               (vol / (table4.header["step_length"] * dom_area))[..., None])
    renorm5 = (table.values[1:-1, 1:-1, 1:-1] *
               (vol / (table.header["step_length"] * dom_area))[..., None, None])
    assert renorm5.sum() > 1.2 * renorm4.sum()


def test_impact_angle_cylindrical():
    """Cylindrical impact axis (cylindrical_coordinates.c.cl:61-75): the
    5-axis table builds, bins are finite/populated, shape matches."""
    from clsim_tpu.tabulator import Axis, CylindricalAxes
    from clsim_tpu.tabulator.axes import default_cylindrical_axes
    medium = make_homogeneous_ice(b400=0.005, a_dust400=0.01)
    spectra = _spectra()
    cfg = PropagationConfig(n_slots=64, max_segment_m=30.0,
                            max_layer_steps=6)
    steps = _beam_steps(cfg.n_slots, 2, direction=(1.0, 0.0, 0.0))
    source = make_reference_source(0.0, 0.0, 0.0, 0.0,
                                   zenith=np.pi / 2, azimuth=np.pi)
    axes = CylindricalAxes([
        Axis(0.0, 200.0, 10, power=2),
        Axis(0.0, np.pi, 4),
        Axis(-200.0, 200.0, 6),
        Axis(0.0, 2000.0, 10, power=2),
        Axis(-1.0, 1.0, 6),
    ])
    table = tabulate([steps], medium, spectra, source, seed=3, axes=axes,
                     cfg=cfg)
    assert table.values.shape == axes.shape
    assert np.isfinite(table.values).all() and table.values.sum() > 0
    # defaults helper wires the axis through
    d5 = default_cylindrical_axes(n_impact=12)
    assert d5.n_dim == 5 and d5.axes[4].n_bins == 12
