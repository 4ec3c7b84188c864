"""Test configuration: the tests run on the CPU, with an 8-device virtual
CPU mesh for the sharding tests, unless JAX_PLATFORMS names another
platform (`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu` runs the
tests marked `gpu` on the card).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def gpu():
    """The GPU the test needs; skips when JAX finds none.  Decided here, at
    run time, never at import or collection (the xdist workers must all
    collect the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {dev.platform!r}")
    return dev


# ---------------------------------------------------------------------------
# fast/slow tiering (round-3 review item 9): the slow tier holds the heavy
# parity / oracle / statistical tests; the default run (`pytest tests/ -q`,
# see pytest.ini addopts) is the < ~5 min fast tier used while iterating.
# Full suite: `pytest tests/ -q -m "slow or not slow"`.
# Centralized here (one list, measured from --durations) instead of scattering
# ~30 decorators across files.
# ---------------------------------------------------------------------------

SLOW_MODULES = {
    "test_oracle",     # 1e6-photon float64-oracle statistical protocols
    "test_golden",     # full golden-run regression configs
    "test_tabulator",  # engine-driven table generation (15-30 s each)
}

SLOW_TESTS = {
    # tests/test_parallel.py (8-device CPU-mesh shard_map compiles)
    "test_ice_fit_step_descends",
    "test_ice_fit_optax_and_transform",
    "test_ice_fit_two_sample_poisson",
    "test_sharded_matches_single_device_statistically",
    "test_sharded_propagate_conserves_counts",
    "test_bootstrap_two_process_psum",
    # tests/test_engine.py
    "test_gradient_matches_finite_difference",
    "test_expected_estimator_folds_angular_acceptance",
    "test_expected_estimator_matches_detect_statistically",
    "test_scatter_history_rings",
    "test_records_absorption_points",
    "test_prescale_reduces_records",
    # tests/test_diff.py
    "test_diff_gradient_matches_engine_ad_and_fd",
    "test_diff_scattering_gradient_bias_bounded",
    # tests/test_pipeline.py
    "test_pipeline_multi_event",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.name.split("[")[0]
        if base in SLOW_TESTS or item.module.__name__ in SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
