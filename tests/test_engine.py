"""End-to-end propagation engine tests against analytic physics oracles.

Strategy (SURVEY.md section 4): exact trajectory equality with the reference
is impossible across RNGs, so we assert *physics contracts* instead --
straight-line survival probabilities, layered-medium optical depths, arrival
times from the group velocity, and statistical properties of the scattered
population."""

import numpy as np
import pytest
import jax.numpy as jnp

from clsim_tpu.geometry import build_geometry, single_string_geometry
from clsim_tpu.medium.functions import DEFAULT_ICE_REF_INDEX
from clsim_tpu.medium.properties import make_homogeneous_ice
from clsim_tpu.ops.spectrum import (make_cherenkov_spectrum,
                                    make_tabulated_spectrum, stack_spectra)
from clsim_tpu.propagate.engine import propagate
from clsim_tpu.types import PropagationConfig, StepBatch


def _spectra(mono_wlen=400.0):
    """Spectrum table: [0] = Cherenkov over the medium range, [1] = a
    near-delta 'flasher' line at mono_wlen for deterministic wavelengths."""
    cher = make_cherenkov_spectrum(DEFAULT_ICE_REF_INDEX, 265.0, 675.0)
    x = np.array([mono_wlen - 1.0, mono_wlen, mono_wlen + 1.0])
    y = np.array([0.0, 1.0, 0.0])
    mono = make_tabulated_spectrum(x, y)
    return stack_spectra([cher, mono])


def _beam_steps(n_slots, photons_per_slot, direction=(1.0, 0.0, 0.0),
                pos=(0.0, 0.0, 0.0), source_type=1):
    """Slot-assigned steps of a pencil beam (flasher-type: no Cherenkov cone)."""
    n = n_slots
    return StepBatch(
        x=jnp.full(n, pos[0], jnp.float32),
        y=jnp.full(n, pos[1], jnp.float32),
        z=jnp.full(n, pos[2], jnp.float32),
        t=jnp.zeros(n, jnp.float32),
        dir_x=jnp.full(n, direction[0], jnp.float32),
        dir_y=jnp.full(n, direction[1], jnp.float32),
        dir_z=jnp.full(n, direction[2], jnp.float32),
        length=jnp.zeros(n, jnp.float32),       # point emission
        beta=jnp.ones(n, jnp.float32),
        num_photons=jnp.full(n, photons_per_slot, jnp.int32),
        weight=jnp.ones(n, jnp.float32),
        identifier=jnp.zeros(n, jnp.int32),
        source_type=jnp.full(n, source_type, jnp.int32))


def _one_dom_geometry(x=50.0, oversize=5.0):
    """A single DOM on the +x axis."""
    return build_geometry([1], [1], [x], [0.0], [0.0], oversize=oversize)


def _shadow_geometry():
    """Three strings nearly on the photon's line of flight: the two NEAREST
    (ranks 1, 2) have DOMs only at z=+200 (pass the 2-D cull, can never be
    hit at z~0), the 3rd-nearest has its DOM exactly in the photon's path.
    The reference tests every culled string
    (sparse_collision_kernel.c.cl:462-587); the top-K approximation must
    use K>=3 here."""
    return build_geometry([0, 1, 2], [0, 0, 0], [10.0, 20.0, 30.0],
                          [0.3, 0.5, 0.8], [200.0, 200.0, 0.0],
                          oversize=12.0)


def _three_group_geometry():
    """Wide main hex + dense DeepCore-style infill + sparse shallow veto
    ring: three (z0, dz, n_doms) string groups."""
    import math
    sids, oids, xs, ys, zs = [], [], [], [], []

    def add_string(si, px, py, z0, dz, nd):
        for d in range(nd):
            sids.append(si)
            oids.append(d)
            xs.append(px)
            ys.append(py)
            zs.append(z0 - d * dz)

    pos = [(0.0, 0.0)] + [(150.0 * math.cos(a), 150.0 * math.sin(a))
                          for a in np.linspace(0, 2 * np.pi, 7)[:-1]]
    for si, (px, py) in enumerate(pos):
        add_string(si, px, py, 80.0, 15.0, 12)
    add_string(len(pos), 20.0, 15.0, 40.0, 7.0, 30)
    for k in range(4):
        a = k * np.pi / 2 + 0.4
        add_string(len(pos) + 1 + k, 400.0 * math.cos(a),
                   400.0 * math.sin(a), 60.0, 25.0, 6)
    return build_geometry(sids, oids, xs, ys, zs, oversize=8.0)


def _isotropic_steps(n, pos, photons_per_slot=8, seed=7):
    rr = np.random.default_rng(seed)
    costh = rr.uniform(-1, 1, n)
    sinth = np.sqrt(1 - costh ** 2)
    phi = rr.uniform(0, 2 * np.pi, n)
    return StepBatch(
        x=jnp.full(n, pos[0], jnp.float32), y=jnp.full(n, pos[1], jnp.float32),
        z=jnp.full(n, pos[2], jnp.float32), t=jnp.zeros(n, jnp.float32),
        dir_x=jnp.asarray(sinth * np.cos(phi), jnp.float32),
        dir_y=jnp.asarray(sinth * np.sin(phi), jnp.float32),
        dir_z=jnp.asarray(costh, jnp.float32),
        length=jnp.zeros(n, jnp.float32), beta=jnp.ones(n, jnp.float32),
        num_photons=jnp.full(n, photons_per_slot, jnp.int32),
        weight=jnp.ones(n, jnp.float32),
        identifier=jnp.zeros(n, jnp.int32),
        source_type=jnp.ones(n, jnp.int32))


def _collision_workload(name):
    """(geometry, slot-assigned steps) for the culled-vs-bruteforce test."""
    from clsim_tpu.geometry import hexagonal_geometry
    from clsim_tpu.workloads import icecube86_geometry
    if name == "single_string":
        return (single_string_geometry(n_doms=24, spacing=17.0, x=12.0,
                                       z_top=200.0, oversize=5.0),
                _beam_steps(512, 32, direction=(0.05, 0.0, 0.99875),
                            pos=(0.0, 0.0, -10.0), source_type=0))
    if name == "hex":
        return (hexagonal_geometry(n_rings=1, string_spacing=60.0,
                                   doms_per_string=12, dom_spacing=15.0,
                                   z_top=80.0, oversize=8.0),
                _isotropic_steps(512, (7.0, -3.0, 11.0)))
    if name == "ic86":
        return (icecube86_geometry(oversize=5.0),
                _isotropic_steps(512, (40.0, 20.0, -250.0), 16))
    if name == "three_group":
        return _three_group_geometry(), _isotropic_steps(512, (10.0, 5.0, 0.0))
    # shadow: a pencil beam along +x at the third string's DOM
    return _shadow_geometry(), _beam_steps(256, 4, direction=(1.0, 0.0, 0.0))


CFG = PropagationConfig(n_slots=512, hist_t_min=0.0, hist_t_max=3200.0,
                        hist_n_bins=400)


class TestBeamAttenuation:
    """Pencil beam at a DOM through (nearly) scatter-free media: the hit
    fraction must equal exp(-optical depth) and the arrival time d/v_group."""

    def test_uniform_medium_survival_and_time(self):
        d = 50.0
        medium = make_homogeneous_ice(b400=1e-9, a_dust400=0.02)
        geo = _one_dom_geometry(x=d, oversize=5.0)
        spectra = _spectra()
        steps = _beam_steps(CFG.n_slots, 64)
        res = propagate(steps, medium, geo, spectra,
                        jnp.asarray([0, 42], jnp.uint32), CFG)

        n_total = 512 * 64
        assert float(res.n_generated) == n_total

        # expected survival to the sphere entry (d - R_eff along the ray,
        # pancake divides only the perpendicular half-width; on-axis entry is
        # at d - R*oversize/pancake... with pancake=1, entry at d - R*oversize)
        r_entry = d - geo.collision_radius
        inv_abs = float(medium.inv_absorption_length(1, 400.0))
        expected_frac = np.exp(-r_entry * inv_abs)
        got_frac = float(res.n_hits) / n_total
        assert got_frac == pytest.approx(expected_frac, rel=0.05)

        # arrival time: r_entry / group velocity in one bin
        hist = np.asarray(res.hist)
        assert hist.shape == (1, CFG.hist_n_bins)
        tbin = hist[0].argmax()
        t_expected = r_entry / float(medium.group_velocity(400.0))
        t_got = CFG.hist_t_min + (tbin + 0.5) * CFG.hist_dt
        assert t_got == pytest.approx(t_expected, abs=2 * CFG.hist_dt)

    def test_layered_medium_optical_depth(self):
        """Vertical beam through two layers with different absorption: the
        survival must match the two-layer optical depth (validates the layer
        walk)."""
        # layer boundary at z=0; layer 0 below, layer 1 above
        medium = make_homogeneous_ice(n_layers=2, z_start=-1000.0,
                                      layer_height=1000.0, b400=1e-9)
        medium = medium._replace(
            a_dust400=jnp.asarray([0.01, 0.05], jnp.float32),
            delta_tau=jnp.asarray([0.0, 0.0], jnp.float32))
        d = 80.0
        z0 = -30.0  # beam starts 30m below the boundary, DOM 50m above it
        # note: an exactly vertical beam is invisible to the collision test
        # (dir_xy^2 > 0 cull, same early-out as the reference's
        # photonDirLenXYSqr check) -- tilt it slightly
        eps = 1e-3
        dzc = float(np.sqrt(1.0 - eps * eps))
        geo = build_geometry([1], [1], [eps * d], [0.0], [z0 + dzc * d],
                             oversize=5.0)
        spectra = _spectra()
        steps = _beam_steps(CFG.n_slots, 64, direction=(eps, 0.0, dzc),
                            pos=(0.0, 0.0, z0))
        cfg = CFG
        res = propagate(steps, medium, geo, spectra,
                        jnp.asarray([0, 7], jnp.uint32), cfg)

        r_entry = d - geo.collision_radius
        inv0 = float(medium.inv_absorption_length(0, 400.0))
        inv1 = float(medium.inv_absorption_length(1, 400.0))
        d_to_boundary = 30.0 / dzc
        tau = d_to_boundary * inv0 + (r_entry - d_to_boundary) * inv1
        expected_frac = np.exp(-tau)
        got_frac = float(res.n_hits) / float(res.n_generated)
        assert got_frac == pytest.approx(expected_frac, rel=0.05)

    def test_downward_beam_crosses_layers(self):
        """Same as above but heading down (exercises the dz<0 walk branch)."""
        medium = make_homogeneous_ice(n_layers=2, z_start=-1000.0,
                                      layer_height=1000.0, b400=1e-9)
        medium = medium._replace(
            a_dust400=jnp.asarray([0.05, 0.01], jnp.float32),
            delta_tau=jnp.asarray([0.0, 0.0], jnp.float32))
        d = 80.0
        z0 = 30.0
        eps = 1e-3
        dzc = float(np.sqrt(1.0 - eps * eps))
        geo = build_geometry([1], [1], [eps * d], [0.0], [z0 - dzc * d],
                             oversize=5.0)
        spectra = _spectra()
        steps = _beam_steps(CFG.n_slots, 64, direction=(eps, 0.0, -dzc),
                            pos=(0.0, 0.0, z0))
        res = propagate(steps, medium, geo, spectra,
                        jnp.asarray([0, 7], jnp.uint32), CFG)
        r_entry = d - geo.collision_radius
        inv1 = float(medium.inv_absorption_length(1, 400.0))
        inv0 = float(medium.inv_absorption_length(0, 400.0))
        d_to_boundary = 30.0 / dzc
        tau = d_to_boundary * inv1 + (r_entry - d_to_boundary) * inv0
        got_frac = float(res.n_hits) / float(res.n_generated)
        assert got_frac == pytest.approx(np.exp(-tau), rel=0.05)

    def test_oblique_beam_many_thin_layers(self):
        """45-degree beam through 10m layers with alternating absorption --
        stresses multiple crossings per segment."""
        n_layers = 100
        medium = make_homogeneous_ice(n_layers=n_layers, z_start=-500.0,
                                      layer_height=10.0, b400=1e-9)
        a = np.where(np.arange(n_layers) % 2 == 0, 0.01, 0.04)
        medium = medium._replace(
            a_dust400=jnp.asarray(a, jnp.float32),
            delta_tau=jnp.zeros(n_layers, jnp.float32))
        s = 1.0 / np.sqrt(2.0)
        d = 120.0
        pos_end = (d * s, 0.0, d * s)
        geo = build_geometry([1], [1], [pos_end[0]], [0.0], [pos_end[2]],
                             oversize=5.0)
        spectra = _spectra()
        steps = _beam_steps(CFG.n_slots, 64, direction=(s, 0.0, s),
                            pos=(0.0, 0.0, 0.0))
        res = propagate(steps, medium, geo, spectra,
                        jnp.asarray([0, 9], jnp.uint32), CFG)

        # numpy oracle: integrate the optical depth along the ray to entry
        r_entry = d - geo.collision_radius
        zs = np.linspace(0.0, r_entry * s, 20001)
        layer = np.clip(((zs - (-500.0)) / 10.0).astype(int), 0, n_layers - 1)
        pa = 400.0 ** 1.08 * 400.0 ** (-1.08)  # D * x^-kappa at 400nm = 1
        inv = np.asarray(
            [float(medium.inv_absorption_length(int(l), 400.0)) for l in
             range(n_layers)])
        path_per_sample = (zs[1] - zs[0]) / s  # ds = dz / s
        tau = inv[layer[:-1]].sum() * path_per_sample
        got_frac = float(res.n_hits) / float(res.n_generated)
        assert got_frac == pytest.approx(np.exp(-tau), rel=0.05)


class TestScattering:
    def test_scattering_smoke(self):
        """Realistic ice: a cascade-like beam near a string produces hits with
        a delayed tail (scattered light)."""
        medium = make_homogeneous_ice(b400=0.06, a_dust400=0.004)
        geo = single_string_geometry(n_doms=24, spacing=17.0, x=12.0,
                                     z_top=200.0, oversize=5.0)
        spectra = _spectra()
        steps = _beam_steps(CFG.n_slots, 64, direction=(0.05, 0.0, 0.99875),
                            pos=(0.0, 0.0, -10.0), source_type=0)
        res = propagate(steps, medium, geo, spectra,
                        jnp.asarray([0, 11], jnp.uint32), CFG)
        assert float(res.n_hits) > 20
        hist = np.asarray(res.hist).sum(axis=0)
        peak = hist.argmax()
        # scattered tail: some light arrives late
        assert hist[peak + 20:].sum() > 0.0

    @pytest.mark.parametrize("geometry", ["single_string", "hex", "ic86",
                                          "three_group", "shadow"])
    def test_culled_collision_matches_bruteforce(self, geometry):
        """The sparse culling pipeline (2D string cull -> top-K ranking ->
        per-string DOM slots) must find exactly the hits the O(N*D) oracle
        finds, on uniform, non-uniform-z (DeepCore-like), multi-group and
        shadowing geometries (K as advise_strings_per_photon recommends)."""
        from clsim_tpu.geometry import advise_strings_per_photon
        geo, steps = _collision_workload(geometry)
        medium = make_homogeneous_ice(b400=0.06, a_dust400=0.004)
        spectra = _spectra()
        seg = 90.0
        k, _ = advise_strings_per_photon(geo, seg, 2)
        hists = {}
        for mode in ["culled", "bruteforce"]:
            cfg = PropagationConfig(n_slots=steps.x.shape[0],
                                    hist_t_min=0.0, hist_t_max=3200.0,
                                    hist_n_bins=400, collision_mode=mode,
                                    max_segment_m=seg,
                                    strings_per_photon=max(k, 2))
            res = propagate(steps, medium, geo, spectra,
                            jnp.asarray([0, 11], jnp.uint32), cfg)
            hists[mode] = np.asarray(res.hist)
        assert hists["bruteforce"].sum() > 20
        np.testing.assert_allclose(hists["culled"], hists["bruteforce"])

    def test_photon_records_mode(self):
        medium = make_homogeneous_ice(b400=1e-9, a_dust400=0.01)
        geo = _one_dom_geometry(x=30.0, oversize=5.0)
        spectra = _spectra()
        cfg = PropagationConfig(n_slots=128, save_photons=True,
                                photon_capacity_per_slot=128)
        steps = _beam_steps(cfg.n_slots, 16)
        res = propagate(steps, medium, geo, spectra,
                        jnp.asarray([0, 5], jnp.uint32), cfg)
        counts = np.asarray(res.rec_count)
        assert counts.sum() == float(res.n_hits)
        # recorded positions must sit on the (pancaked-undone) sphere surface:
        # with pancake=1, |pos_rel| == R*oversize
        k = counts[0]
        if k > 0:
            px = np.asarray(res.rec["pos_x"])[0, :k]
            py = np.asarray(res.rec["pos_y"])[0, :k]
            pz = np.asarray(res.rec["pos_z"])[0, :k]
            r = np.sqrt(px ** 2 + py ** 2 + pz ** 2)
            np.testing.assert_allclose(r, geo.collision_radius, atol=1e-3)
        # weights are 1/bias at the sampled wavelength
        assert np.all(np.asarray(res.rec["weight"])[counts > 0] >= 0)

    def test_conservation_no_detector_far_away(self):
        """With the DOM far outside reach, no hits are recorded and all
        photons are eventually absorbed (loop terminates)."""
        medium = make_homogeneous_ice(b400=0.05, a_dust400=0.01)
        geo = _one_dom_geometry(x=5000.0)
        spectra = _spectra()
        steps = _beam_steps(256, 8, source_type=0)
        cfg = PropagationConfig(n_slots=256)
        res = propagate(steps, medium, geo, spectra,
                        jnp.asarray([0, 3], jnp.uint32), cfg)
        assert float(res.n_hits) == 0
        assert float(res.n_generated) == 256 * 8


class TestDifferentiability:
    def test_gradient_matches_finite_difference(self):
        """d(total hit weight)/d(a_dust400) via soft-binned expectation:
        reparameterized trajectories make the FD and AD derivatives agree."""
        import jax

        d = 40.0
        geo = _one_dom_geometry(x=d, oversize=5.0)
        spectra = _spectra()
        cfg = PropagationConfig(n_slots=256, soft_binning=True,
                                estimator="expected")
        steps = _beam_steps(cfg.n_slots, 16)
        key = jnp.asarray([0, 21], jnp.uint32)

        def loss(a_dust):
            medium = make_homogeneous_ice(b400=1e-9, a_dust400=1.0)
            medium = medium._replace(
                a_dust400=jnp.full(2, a_dust, jnp.float32))
            res = propagate(steps, medium, geo, spectra, key, cfg,
                            max_iterations=8)
            return res.weight_hits

        a0 = 0.02
        g = float(jax.grad(loss)(jnp.float32(a0)))
        eps = 1e-3
        fd = (float(loss(jnp.float32(a0 + eps))) -
              float(loss(jnp.float32(a0 - eps)))) / (2 * eps)
        # the survival fraction is smooth in a_dust: exp(-d*pa*a_dust)
        assert g == pytest.approx(fd, rel=0.05)
        # and both must match the analytic derivative of N*exp(-r*inv_abs)
        assert g < 0.0

    def test_expected_estimator_matches_detect_statistically(self):
        """The continuous-absorption estimator must agree with the faithful
        accept/reject estimator in expectation (same beam-at-DOM setup)."""
        d = 40.0
        geo = _one_dom_geometry(x=d, oversize=5.0)
        spectra = _spectra()
        key = jnp.asarray([0, 33], jnp.uint32)
        medium = make_homogeneous_ice(b400=1e-9, a_dust400=0.02)
        results = {}
        for est in ["detect", "expected"]:
            cfg = PropagationConfig(n_slots=512, estimator=est)
            steps = _beam_steps(cfg.n_slots, 32)
            res = propagate(steps, medium, geo, spectra, key, cfg)
            results[est] = float(res.weight_hits) / float(res.n_generated)
        assert results["expected"] == pytest.approx(results["detect"], rel=0.05)

    def test_expected_estimator_folds_angular_acceptance(self):
        """expected_angular_poly scales the deposited weight by the DOM
        angular acceptance at the photon direction, matching the per-record
        factor in I3PhotonToMCPEConverter.cxx:466-475.  A constant poly must
        scale weight_hits exactly; (1,) must be a no-op."""
        d = 40.0
        geo = _one_dom_geometry(x=d, oversize=5.0)
        spectra = _spectra()
        key = jnp.asarray([0, 44], jnp.uint32)
        medium = make_homogeneous_ice(b400=1e-9, a_dust400=0.02)
        out = {}
        for poly in [None, (1.0,), (0.25,)]:
            cfg = PropagationConfig(n_slots=512, estimator="expected",
                                    expected_angular_poly=poly)
            steps = _beam_steps(cfg.n_slots, 32)
            res = propagate(steps, medium, geo, spectra, key, cfg)
            out[poly] = float(res.weight_hits)
        assert out[(1.0,)] == pytest.approx(out[None], rel=1e-6)
        assert out[(0.25,)] == pytest.approx(0.25 * out[None], rel=1e-5)


class TestSaveAllPhotons:
    def test_records_absorption_points(self):
        """SAVE_ALL_PHOTONS mode: every photon is recorded at its absorption
        point regardless of the detector (propagation_kernel.c.cl:800-826)."""
        medium = make_homogeneous_ice(b400=0.05, a_dust400=0.05)
        geo = _one_dom_geometry(x=5000.0)
        spectra = _spectra()
        cfg = PropagationConfig(n_slots=64, save_photons=True,
                                save_all_photons=True, stop_on_detection=False,
                                photon_capacity_per_slot=32)
        steps = _beam_steps(cfg.n_slots, 8, source_type=0)
        res = propagate(steps, medium, geo, spectra,
                        jnp.asarray([0, 12], jnp.uint32), cfg)
        counts = np.asarray(res.rec_count)
        # every generated photon is recorded exactly once
        assert counts.sum() == float(res.n_generated)
        # path lengths are exponential-ish: mean ~ abs length scale
        k = counts[0]
        d = np.asarray(res.rec["cherenkov_dist"])[0, :min(k, 32)]
        assert d.min() > 0.0

    def test_prescale_reduces_records(self):
        medium = make_homogeneous_ice(b400=0.05, a_dust400=0.05)
        geo = _one_dom_geometry(x=5000.0)
        spectra = _spectra()
        cfg = PropagationConfig(n_slots=128, save_photons=True,
                                save_all_photons=True, stop_on_detection=False,
                                save_all_prescale=0.25,
                                photon_capacity_per_slot=32)
        steps = _beam_steps(cfg.n_slots, 16, source_type=0)
        res = propagate(steps, medium, geo, spectra,
                        jnp.asarray([0, 13], jnp.uint32), cfg)
        frac = np.asarray(res.rec_count).sum() / float(res.n_generated)
        assert frac == pytest.approx(0.25, abs=0.05)


class TestPhotonHistory:
    def test_scatter_history_rings(self):
        """SAVE_PHOTON_HISTORY: each recorded photon carries the last-H
        scatter positions + absorption-length depths in a ring
        (I3CLSimPhotonHistory; propagation_kernel.c.cl:452-455, 833-837)."""
        H = 4
        medium = make_homogeneous_ice(b400=0.08, a_dust400=0.03)
        geo = _one_dom_geometry(x=5000.0)
        spectra = _spectra()
        cfg = PropagationConfig(n_slots=64, save_photons=True,
                                save_all_photons=True, stop_on_detection=False,
                                photon_capacity_per_slot=32,
                                photon_history_entries=H)
        steps = _beam_steps(cfg.n_slots, 8,
                            pos=(100.0, 100.0, 100.0), source_type=0)
        res = propagate(steps, medium, geo, spectra,
                        jnp.asarray([0, 14], jnp.uint32), cfg)
        counts = np.asarray(res.rec_count)
        assert counts.sum() == float(res.n_generated)
        for f in ("hist_x", "hist_y", "hist_z", "hist_abs"):
            assert res.rec[f].shape == (cfg.n_slots,
                                        cfg.photon_capacity_per_slot, H)
        ns = np.asarray(res.rec["num_scatters"]).astype(int)
        habs = np.asarray(res.rec["hist_abs"])
        hx = np.asarray(res.rec["hist_x"])
        depth = np.asarray(res.rec["dist_in_abs_lens"])
        recorded = (np.arange(cfg.photon_capacity_per_slot)[None, :]
                    < counts[:, None])
        assert ns[recorded].max() >= 1  # this medium scatters

        filled = np.minimum(ns, H)
        idx = np.arange(H)[None, None, :]
        used = recorded[:, :, None] & (idx < filled[:, :, None])
        unused = recorded[:, :, None] & (idx >= filled[:, :, None])
        # unused ring entries stay zeroed (fresh photons clear the ring)
        assert np.all(habs[unused] == 0.0)
        assert np.all(hx[unused] == 0.0)
        # scatter depths are positive and bounded by the final depth;
        # positions are near the emission region, not at the origin
        assert np.all(habs[used] > 0.0)
        cap = np.broadcast_to(depth[:, :, None] + 1e-4, habs.shape)
        assert np.all(habs[used] <= cap[used])
        assert np.all(np.abs(hx[used]) > 1.0)
        # within-ring depths are non-decreasing in append order (ns <= H case)
        short = recorded & (ns >= 2) & (ns <= H)
        si, sj = np.nonzero(short)
        for i, j in zip(si[:64], sj[:64]):
            seq = habs[i, j, :ns[i, j]]
            assert np.all(np.diff(seq) >= 0.0)


def test_advise_strings_per_photon():
    from clsim_tpu.geometry import advise_strings_per_photon, hexagonal_geometry
    geo = _shadow_geometry()
    rec, reason = advise_strings_per_photon(geo, 120.0, configured=2)
    assert rec >= 3 and reason is not None
    # homogeneous hex lattice: K=2 is fine, no warning
    hex_geo = hexagonal_geometry(n_rings=2, doms_per_string=10,
                                 dom_spacing=17.0, z_top=80.0)
    rec2, reason2 = advise_strings_per_photon(hex_geo, 35.0, configured=2)
    assert reason2 is None


class TestEngineInvariants:
    """Configurations the engine serves, each held to an invariant that
    needs no second implementation."""

    @pytest.mark.parametrize("photons_per_slot", [1, 8, 200])
    def test_drains_every_photon(self, photons_per_slot):
        """The while loop runs until every slot is empty: every photon of
        every slot is generated, whatever the per-slot depth (nothing is
        dropped or abandoned)."""
        n = 128
        medium = make_homogeneous_ice(b400=0.05, a_dust400=0.02)
        geo = single_string_geometry(n_doms=24, spacing=17.0, x=12.0,
                                     z_top=200.0, oversize=5.0)
        steps = _beam_steps(n, photons_per_slot, source_type=0)
        nph = np.asarray(steps.num_photons).copy()
        nph[::3] = 0                       # empty slots drain immediately
        steps = steps._replace(num_photons=jnp.asarray(nph))
        res = propagate(steps, medium, geo, _spectra(),
                        jnp.asarray([0, 5], jnp.uint32),
                        PropagationConfig(n_slots=n))
        assert float(res.n_generated) == float(nph.sum())
        assert int(res.n_iterations) >= photons_per_slot
        assert np.isfinite(np.asarray(res.hist)).all()

    @pytest.mark.parametrize("save_all", [False, True])
    def test_records_count_matches(self, save_all):
        """Record rings count exactly what the counters count: one record
        per hit, or with SAVE_ALL_PHOTONS one per absorbed photon (every
        photon, with the detector out of reach)."""
        medium = make_homogeneous_ice(b400=0.03, a_dust400=0.01)
        x = 5000.0 if save_all else 30.0
        geo = _one_dom_geometry(x=x, oversize=5.0)
        cfg = PropagationConfig(n_slots=128, save_photons=True,
                                save_all_photons=save_all,
                                stop_on_detection=not save_all,
                                photon_capacity_per_slot=64)
        steps = _beam_steps(cfg.n_slots, 16)
        res = propagate(steps, medium, geo, _spectra(),
                        jnp.asarray([0, 6], jnp.uint32), cfg)
        counts = np.asarray(res.rec_count)
        target = float(res.n_generated) if save_all else float(res.n_hits)
        assert target > 0
        assert counts.sum() == target
        assert counts.max() <= cfg.photon_capacity_per_slot

    def test_flasher_multi_spectrum_dispatch(self):
        """Stacked spectra: slots with source_type 1 draw from the LED
        table (380-430 nm), source_type 0 from the Cherenkov spectrum."""
        from clsim_tpu.ops.spectrum import make_tabulated_spectrum
        cher = make_cherenkov_spectrum(DEFAULT_ICE_REF_INDEX, 265.0, 675.0)
        wl = np.linspace(380.0, 430.0, 11)
        led = make_tabulated_spectrum(
            wl, np.exp(-0.5 * ((wl - 405.0) / 10.0) ** 2))
        spectra = stack_spectra([cher, led])
        n = 256
        st = np.zeros(n, np.int32)
        st[n // 2:] = 1
        steps = _beam_steps(n, 8)._replace(source_type=jnp.asarray(st),
                                           identifier=jnp.asarray(st))
        cfg = PropagationConfig(n_slots=n, save_photons=True,
                                save_all_photons=True,
                                stop_on_detection=False,
                                photon_capacity_per_slot=8)
        res = propagate(steps, make_homogeneous_ice(b400=0.05, a_dust400=0.05),
                        _one_dom_geometry(x=5000.0), spectra,
                        jnp.asarray([0, 8], jnp.uint32), cfg)
        counts = np.asarray(res.rec_count)
        valid = np.arange(8)[None, :] < counts[:, None]
        wlen = np.asarray(res.rec["wavelength"])[valid]
        src = np.asarray(res.rec["identifier"])[valid]
        assert (src == 1).sum() > 100 and (src == 0).sum() > 100
        assert ((wlen[src == 1] >= 380.0) & (wlen[src == 1] <= 430.0)).all()
        cw = wlen[src == 0]
        assert cw.min() >= 265.0 and cw.max() <= 675.0
        assert ((cw < 380.0) | (cw > 430.0)).mean() > 0.5

    @pytest.mark.parametrize("kind", ["water", "photonics"])
    def test_other_media_propagate(self, kind):
        """Sea water (tabulated wavelength factors, Petzold/Rayleigh
        scattering) and a photonics-format separable table drain, deposit
        finite hits, and arrive after the straight-line light time."""
        if kind == "water":
            from clsim_tpu.medium.antares import make_antares_water
            medium = make_antares_water()
        else:
            medium = _photonics_medium()
        cher = make_cherenkov_spectrum(medium.ref_index,
                                       float(medium.min_wlen),
                                       float(medium.max_wlen))
        # source_type 1: the beam keeps its direction (no Cherenkov cone)
        spectra = stack_spectra([cher, cher])
        d = 30.0
        geo = _one_dom_geometry(x=d, oversize=5.0)
        steps = _beam_steps(256, 16)
        cfg = PropagationConfig(n_slots=256, hist_t_min=0.0,
                                hist_t_max=3200.0, hist_n_bins=400)
        res = propagate(steps, medium, geo, spectra,
                        jnp.asarray([0, 9], jnp.uint32), cfg)
        assert float(res.n_generated) == 256 * 16
        assert float(res.n_hits) > 10
        hist = np.asarray(res.hist)[0]
        assert np.isfinite(hist).all()
        first = np.nonzero(hist)[0][0]
        t_min = (d - geo.collision_radius) / 0.3   # no faster than c
        assert (first + 1) * cfg.hist_dt >= t_min

    def test_nonuniform_bias_weights(self):
        """A log-spaced wavelength-bias grid: each recorded weight is
        step.weight / bias(wavelength), the bias linearly interpolated on
        the non-uniform grid (np.interp on the recorded wavelength)."""
        bx = np.geomspace(265.0, 675.0, 23)
        by = 0.2 + 0.15 * np.sin(np.linspace(0, 5, 23)) ** 2
        cher = make_cherenkov_spectrum(DEFAULT_ICE_REF_INDEX, 265.0, 675.0,
                                       bias_wlen_nm=bx, bias_values=by)
        spectra = stack_spectra([cher, cher])   # source_type 1: no cone
        cfg = PropagationConfig(n_slots=256, save_photons=True,
                                photon_capacity_per_slot=16)
        res = propagate(_beam_steps(256, 16),
                        make_homogeneous_ice(b400=1e-9, a_dust400=0.01),
                        _one_dom_geometry(x=20.0, oversize=5.0), spectra,
                        jnp.asarray([0, 10], jnp.uint32), cfg)
        counts = np.asarray(res.rec_count)
        valid = np.arange(16)[None, :] < counts[:, None]
        w = np.asarray(res.rec["weight"])[valid]
        wl = np.asarray(res.rec["wavelength"])[valid]
        assert len(w) > 50
        np.testing.assert_allclose(w, 1.0 / np.interp(wl, bx, by), rtol=1e-5)


def _photonics_medium():
    """A two-layer photonics-format table (MakeIceCubeMediumProperties-
    Photonics.py input) with smooth wavelength dependence."""
    from clsim_tpu.medium.photonics import parse_photonics_ice_table
    nw, w0, dw = 16, 300.0, 20.0
    wl = w0 + dw / 2 + dw * np.arange(nw)
    lines = ["NLAYER 2", f"NWVL {nw} {w0} {dw}"]
    for i, (a, b) in enumerate(((0.01, 0.03), (0.02, 0.05))):
        lines.append(f"LAYER {-500.0 + 500.0 * i} {500.0 * i}")
        lines.append("ABS " + " ".join(map(str, a * (wl / 400.0) ** -1.08)))
        lines.append("SCAT " + " ".join(
            map(str, b * 0.06 * (wl / 400.0) ** -0.9)))
        lines.append("COS " + " ".join(["0.94"] * nw))
        lines.append("N_GROUP " + " ".join(map(str, 1.36 + 10.0 / wl)))
        lines.append("N_PHASE " + " ".join(map(str, 1.32 + 10.0 / wl)))
    return parse_photonics_ice_table("\n".join(lines))
