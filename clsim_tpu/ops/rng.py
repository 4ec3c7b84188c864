"""Counter-based RNG utilities.

The reference uses a per-work-item multiply-with-carry stream seeded from a
safeprimes file (resources/kernels/mwcrng_kernel.cl, private/opencl/
mwcrng_init.h).  This package replaces it with JAX's counter-based
threefry: a single base key, folded with structured counters, gives every
(batch, iteration, purpose) its own independent stream with no state to
store or restore -- and, crucially, samples that do not depend on the medium
parameters, so inverse-CDF transforms are reparameterized and differentiable
(the BASELINE north-star contract).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def base_key(seed: int) -> jax.Array:
    return jax.random.PRNGKey(seed)


def iter_key(key: jax.Array, iteration) -> jax.Array:
    """Key for one propagation-loop iteration (all lanes share it; per-lane
    decorrelation comes from the draw shape)."""
    return jax.random.fold_in(key, iteration)


def uniforms(key: jax.Array, shape, n: int):
    """Draw n independent uniform[0,1) blocks of `shape` in one call.

    Returns an array u of shape (n,) + shape; u[i] plays the role of the
    reference's i-th RNG_CALL in the loop body.  Sampling all blocks at once
    issues one wide draw instead of many tiny ones.
    """
    return jax.random.uniform(key, (n,) + tuple(shape), dtype=jnp.float32)


def uniform_oc(u):
    """Map [0,1) to (0,1] -- the reference's RNG_CALL_UNIFORM_OC, safe for
    log(u)."""
    return 1.0 - u
