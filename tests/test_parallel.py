"""Multi-device sharding tests on the virtual 8-device CPU mesh (conftest
forces xla_force_host_platform_device_count=8), mirroring the reference's
no-GPU distributed test strategy (resources/tests/testCLSimServer.py)."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from clsim_tpu.geometry import single_string_geometry
from clsim_tpu.medium.properties import make_homogeneous_ice
from clsim_tpu.parallel.mesh import (IceFit, make_mesh, make_sharded_propagate,
                                     shard_steps)
from clsim_tpu.propagate.engine import propagate
from clsim_tpu.types import PropagationConfig
from test_engine import _beam_steps, _one_dom_geometry, _spectra


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return make_mesh()


def test_sharded_propagate_conserves_counts(mesh):
    medium = make_homogeneous_ice(b400=1e-9, a_dust400=0.02)
    geo = _one_dom_geometry(x=40.0, oversize=5.0)
    spectra = _spectra()
    cfg = PropagationConfig(n_slots=64)  # per-device slots
    steps = _beam_steps(64 * 8, 16)
    steps = shard_steps(steps, mesh)
    run = make_sharded_propagate(mesh, cfg)
    res = run(steps, medium, geo, spectra, jnp.asarray([0, 17], jnp.uint32))
    assert float(res.n_generated) == 64 * 8 * 16
    expected = np.exp(-(40.0 - geo.collision_radius)
                      * float(medium.inv_absorption_length(1, 400.0)))
    assert float(res.n_hits) / float(res.n_generated) == pytest.approx(
        expected, rel=0.05)


def test_sharded_matches_single_device_statistically(mesh):
    """8-way sharded and single-device runs agree on the hit fraction."""
    medium = make_homogeneous_ice(b400=0.05, a_dust400=0.01)
    geo = single_string_geometry(n_doms=24, spacing=17.0, x=10.0,
                                 z_top=200.0, oversize=5.0)
    spectra = _spectra()
    # use the low-variance expected estimator so modest photon counts give a
    # statistically meaningful comparison
    cfg = PropagationConfig(n_slots=64, estimator="expected")
    steps8 = shard_steps(_beam_steps(64 * 8, 16, direction=(0.05, 0.0, 0.99875),
                                     pos=(0.0, 0.0, -10.0), source_type=0), mesh)
    run = make_sharded_propagate(mesh, cfg)
    res8 = run(steps8, medium, geo, spectra, jnp.asarray([0, 23], jnp.uint32))

    cfg1 = PropagationConfig(n_slots=512, estimator="expected")
    steps1 = _beam_steps(512, 16, direction=(0.05, 0.0, 0.99875),
                         pos=(0.0, 0.0, -10.0), source_type=0)
    res1 = propagate(steps1, medium, geo, spectra,
                     jnp.asarray([0, 24], jnp.uint32), cfg1)

    f8 = float(res8.weight_hits) / float(res8.n_generated)
    f1 = float(res1.weight_hits) / float(res1.n_generated)
    assert f8 == pytest.approx(f1, rel=0.25)  # statistical agreement


def test_ice_fit_step_descends(mesh):
    """One sharded SGD step on b400 must reduce the loss against a target
    histogram produced by a different b400 (BASELINE config #5 smoke)."""
    geo = _one_dom_geometry(x=30.0, oversize=5.0)
    spectra = _spectra()
    cfg = PropagationConfig(n_slots=32, estimator="expected",
                            soft_binning=True)
    steps = shard_steps(_beam_steps(32 * 8, 8), mesh)
    key = jnp.asarray([0, 31], jnp.uint32)

    medium = make_homogeneous_ice(b400=0.02, a_dust400=0.01)
    run = make_sharded_propagate(mesh, cfg)
    target = run(steps, medium, geo, spectra, key).hist

    fit = IceFit(mesh, cfg, geo, spectra, learning_rate=1e-7,
                 max_iterations=48)
    params0 = {"a_dust400": jnp.full(2, 0.013, jnp.float32)}
    params1, loss0 = fit.step(params0, medium, steps, key, target)
    params2, loss1 = fit.step(
        jax.tree.map(jnp.asarray, params1), medium, steps, key, target)
    assert float(loss1) < float(loss0)
    # parameters moved toward the target value 0.01
    assert float(params1["a_dust400"][0]) < 0.013


def test_ice_fit_optax_and_transform(mesh):
    """IceFit with an optax optimizer (state carried across steps) and a
    log-space param_transform descends toward the target and moves the
    transformed parameter the right way (the production fit configuration
    of scripts/fit_demo.py)."""
    import optax

    geo = _one_dom_geometry(x=30.0, oversize=5.0)
    spectra = _spectra()
    cfg = PropagationConfig(n_slots=32, estimator="expected",
                            soft_binning=True)
    steps = shard_steps(_beam_steps(32 * 8, 8), mesh)
    key = jnp.asarray([0, 31], jnp.uint32)

    medium = make_homogeneous_ice(b400=0.02, a_dust400=0.01)
    run = make_sharded_propagate(mesh, cfg)
    target = run(steps, medium, geo, spectra, key).hist

    def tf(p):
        return {"a_dust400": jnp.exp(p["log_a"])}

    fit = IceFit(mesh, cfg, geo, spectra, max_iterations=48,
                 optimizer=optax.adam(0.05), param_transform=tf)
    params = {"log_a": jnp.full(2, np.log(0.013), jnp.float32)}
    losses = []
    for _ in range(3):
        params, loss = fit.step(params, medium, steps, key, target)
        params = jax.tree.map(jnp.asarray, params)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    # moved toward the target value 0.01 (and stayed positive by
    # construction of the log transform)
    assert float(jnp.exp(params["log_a"][0])) < 0.013


def test_ice_fit_two_sample_poisson(mesh):
    """IceFit's expectation-matching options: poisson per-bin weighting +
    the two-independent-sample gradient (unbiased for the expectation
    residual, no Var(hist) penalty).  The parameter must move toward the
    target value under a fresh key per step."""
    import optax

    geo = _one_dom_geometry(x=30.0, oversize=5.0)
    spectra = _spectra()
    cfg = PropagationConfig(n_slots=32, estimator="expected",
                            soft_binning=True)
    steps = shard_steps(_beam_steps(32 * 8, 8), mesh)

    medium = make_homogeneous_ice(b400=0.02, a_dust400=0.01)
    run = make_sharded_propagate(mesh, cfg)
    target = run(steps, medium, geo, spectra,
                 jnp.asarray([0, 77], jnp.uint32)).hist

    fit = IceFit(mesh, cfg, geo, spectra, max_iterations=48,
                 optimizer=optax.adam(0.05), loss="poisson",
                 two_sample=True)
    params = {"a_dust400": jnp.full(2, 0.014, jnp.float32)}
    for it in range(4):
        params, loss = fit.step(params, medium, steps,
                                jnp.asarray([0, 100 + it], jnp.uint32),
                                target)
        params = jax.tree.map(jnp.asarray, params)
    assert float(loss) >= 0.0
    assert float(params["a_dust400"][0]) < 0.014


def test_bootstrap_single_process_noop(monkeypatch):
    """initialize_distributed is a harmless no-op outside a cluster; the
    per-process step slice covers the global batch exactly once."""
    from clsim_tpu.parallel import bootstrap
    for v in ("COORDINATOR_ADDRESS", "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    assert bootstrap.initialize_distributed() is False
    sl = bootstrap.process_step_slice(1024)
    assert (sl.start, sl.stop) == (0, 1024)
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    monkeypatch.setattr(jax, "process_index", lambda: 2)
    sl = bootstrap.process_step_slice(1024)
    assert (sl.start, sl.stop) == (512, 768)
    with pytest.raises(ValueError):
        bootstrap.process_step_slice(1023)
    monkeypatch.undo()
    mesh = bootstrap.global_photon_mesh()
    assert mesh.devices.size == len(jax.devices())


def test_import_does_not_initialize_backend():
    """`import clsim_tpu` must not touch the XLA backend: on a multi-host
    cluster, jax.distributed.initialize has to run BEFORE any backend-initializing
    call, so module-scope device arrays anywhere in the package would make
    multi-host bootstrap impossible (found via the 2-process test below:
    DEFAULT_ICE_REF_INDEX used to be a module-scope jnp array)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from jax._src import xla_bridge;"
        "import clsim_tpu; import clsim_tpu.parallel.bootstrap;"
        "assert not xla_bridge._backends, 'import initialized XLA backend'")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()[-2000:]


def test_bootstrap_two_process_psum(tmp_path):
    """REAL multi-process distributed run (round-4 review item 5): two
    subprocess CPU workers (2 local devices each) wire themselves into one
    4-device JAX runtime through bootstrap.initialize_distributed's MAIN
    branch, each feeds only its process_step_slice of the global step
    batch, and the cross-process psum'd histogram must equal a
    single-process 4-device run of the identical workload.  The analog of
    the reference proving its client/server layer with real processes
    (resources/tests/testCLSimServer.py:26-42)."""
    import socket
    import subprocess
    import sys

    worker = os.path.join(os.path.dirname(__file__), "dist_worker.py")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device counts
    for v in ("COORDINATOR_ADDRESS", "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE"):
        env.pop(v, None)  # the truth run must take the single-process branch
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    out_dist = str(tmp_path / "dist.npz")
    out_truth = str(tmp_path / "truth.npz")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(rank), out_dist],
        env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in (0, 1)]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    truth = subprocess.run(
        [sys.executable, worker, str(port), "-1", out_truth],
        env=env, cwd=repo, capture_output=True, timeout=600)
    assert truth.returncode == 0, truth.stdout[-3000:] + truth.stderr[-2000:]

    d = np.load(out_dist)
    t = np.load(out_truth)
    assert int(d["process_count"]) == 2 and int(t["process_count"]) == 1
    assert d["n_generated"] == t["n_generated"]
    assert d["n_hits"] == t["n_hits"], (d["n_hits"], t["n_hits"])
    assert d["n_hits"] > 20, "workload produced too few hits"
    np.testing.assert_allclose(d["hist"], t["hist"], rtol=1e-5, atol=1e-6)


def test_api_simulation_mesh_serves_engine(mesh):
    """`Simulation(mesh=...)` shards the slot batch over the mesh and psums
    the result: every photon of the particles' steps is generated, as in
    the unsharded Simulation on the same particles."""
    from clsim_tpu.api import Simulation
    from clsim_tpu.sources import Particle, ParticleType
    medium = make_homogeneous_ice(b400=0.04, a_dust400=0.006)
    geo = single_string_geometry(n_doms=8, spacing=17.0, x=20.0,
                                 z_top=60.0, oversize=5.0)
    cfg = PropagationConfig(n_slots=64)
    cascade = Particle.cascade(ParticleType.EMinus, (0.0, 0.0, 0.0), 0.0,
                               20.0, 1.2, 0.3)
    out = {}
    for label, m in (("mesh", mesh), ("single", None)):
        sim = Simulation(medium=medium, geometry=geo, config=cfg, mesh=m)
        res = sim.simulate([cascade], seed=3)
        out[label] = float(res.n_generated)
        assert np.isfinite(np.asarray(res.hist)).all()
    assert out["mesh"] == out["single"] > 0
