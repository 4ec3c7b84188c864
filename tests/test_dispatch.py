"""propagate_auto: the single entry point for an int seed or a key."""

import numpy as np
import jax.numpy as jnp

from clsim_tpu.medium.functions import DEFAULT_ICE_REF_INDEX
from clsim_tpu.medium.properties import make_homogeneous_ice
from clsim_tpu.ops.spectrum import make_cherenkov_spectrum, stack_spectra
from clsim_tpu.propagate.dispatch import propagate_auto
from clsim_tpu.geometry import build_geometry
from clsim_tpu.types import PropagationConfig, StepBatch


def _setup(n=256):
    medium = make_homogeneous_ice(b400=1e-9, a_dust400=0.02)
    geo = build_geometry([1], [1], [40.0], [0.0], [0.0], oversize=5.0)
    from clsim_tpu.ops.spectrum import make_tabulated_spectrum
    mono = make_tabulated_spectrum(np.array([399.0, 400.0, 401.0]),
                                   np.array([0.0, 1.0, 0.0]))
    spectra = stack_spectra([make_cherenkov_spectrum(
        DEFAULT_ICE_REF_INDEX, 265.0, 675.0), mono])
    steps = StepBatch(
        x=jnp.zeros(n), y=jnp.zeros(n), z=jnp.zeros(n), t=jnp.zeros(n),
        dir_x=jnp.ones(n), dir_y=jnp.zeros(n), dir_z=jnp.zeros(n),
        length=jnp.zeros(n), beta=jnp.ones(n),
        num_photons=jnp.full(n, 4, jnp.int32),
        weight=jnp.ones(n), identifier=jnp.zeros(n, jnp.int32),
        source_type=jnp.ones(n, jnp.int32))  # flasher-type: no Cherenkov cone
    return medium, geo, spectra, steps


def test_engine_backend_accepts_key_and_seed():
    medium, geo, spectra, steps = _setup()
    cfg = PropagationConfig(n_slots=256)
    a = propagate_auto(steps, medium, geo, spectra, 7, cfg)
    b = propagate_auto(steps, medium, geo, spectra,
                       jnp.asarray([0, 7], jnp.uint32), cfg)
    np.testing.assert_allclose(np.asarray(a.hist), np.asarray(b.hist))


def test_engine_path_has_no_diagnostics():
    """The engine drains every slot, so there are no loss counters to
    report: every photon is generated, and the result carries only the
    histogram, the counters and the records."""
    from clsim_tpu.propagate.engine import PropagationResult
    medium, geo, spectra, steps = _setup(n=256)
    cfg = PropagationConfig(n_slots=256)
    res = propagate_auto(steps, medium, geo, spectra, 7, cfg)
    assert float(res.n_generated) == 256 * 4
    assert float(res.n_hits) > 0
    assert PropagationResult._fields == (
        "hist", "n_generated", "n_hits", "weight_hits", "n_iterations",
        "rec_count", "rec")
