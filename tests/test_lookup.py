"""ops/lookup.py helpers against plain indexing and .at[] updates.

Every helper must return exactly what the indexing form returns; the chip
smoke (chip_smoke.py phase 1) repeats the gather cases on the GPU, where a
float32 product at the default precision may run in TF32."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from clsim_tpu.ops.lookup import (_bf16_split, compact_scatter_add,
                                  interp_onehot, masked_set, onehot_gather,
                                  ring_write, select_rows_exact,
                                  shifted_window_table)


def _bits(a):
    return (np.asarray(a, np.float32) + np.float32(0.0)).view(np.uint32)


def _table(shape, seed=0):
    """Full-mantissa values over many binades (a smooth table would hide
    rounding)."""
    r = np.random.default_rng(seed)
    return jnp.asarray(r.standard_normal(shape)
                       * np.exp(r.uniform(-8.0, 8.0, shape)), jnp.float32)


@pytest.mark.parametrize("shape", [(171,), (171, 99), (86, 240), (3, 1)])
def test_onehot_gather_is_indexing(shape):
    t = _table(shape)
    idx = jnp.asarray(np.random.default_rng(1).integers(0, shape[0], 4096),
                      jnp.int32)
    assert np.array_equal(_bits(onehot_gather(t, idx)), _bits(t[idx]))


@pytest.mark.parametrize("n_features", [1, 5])
def test_select_rows_exact_is_indexing(n_features):
    t = _table((86, n_features), seed=2)
    idx = jnp.asarray(np.random.default_rng(3).integers(0, 86, 4096),
                      jnp.int32)
    assert np.array_equal(_bits(select_rows_exact(t, idx)), _bits(t[idx]))


def test_bf16_split_parts_are_exact():
    """Each part is exactly representable in bfloat16 (hence in TF32) and
    (hi + mid) + lo rebuilds the f32 value bit for bit."""
    t = _table((100000,), seed=4)
    parts = _bf16_split(t)
    for p in parts:
        assert np.array_equal(
            _bits(p), _bits(p.astype(jnp.bfloat16).astype(jnp.float32)))
    hi, mid, lo = parts
    assert np.array_equal(_bits((hi + mid) + lo), _bits(t))


@pytest.mark.parametrize("uniform", [True, False])
def test_interp_onehot_matches_interp(uniform):
    xp = (jnp.linspace(265.0, 675.0, 43) if uniform else
          jnp.asarray(np.geomspace(265.0, 675.0, 23), jnp.float32))
    fp = _table(xp.shape, seed=5)
    x = jnp.asarray(np.random.default_rng(6).uniform(200.0, 750.0, 4096),
                    jnp.float32)
    got = np.asarray(interp_onehot(x, xp, fp))
    k = np.clip(np.searchsorted(np.asarray(xp), np.asarray(x),
                                side="right") - 1, 0, xp.shape[0] - 2)
    assert np.array_equal(_bits(np.asarray(xp)[k]),
                          _bits(onehot_gather(xp[:-1], jnp.asarray(k))))
    np.testing.assert_allclose(got, np.asarray(jnp.interp(x, xp, fp)),
                               rtol=1e-5, atol=1e-5 * float(
                                   jnp.max(jnp.abs(fp))))


def test_masked_set_and_ring_write_are_at_set():
    r = np.random.default_rng(7)
    arr = _table((512, 16), seed=8)
    idx = jnp.asarray(r.integers(0, 16, 512), jnp.int32)
    rows = jnp.arange(512)
    assert np.array_equal(np.asarray(masked_set(arr, idx, 1e30)),
                          np.asarray(arr.at[rows, idx].set(1e30)))
    val = _table((512,), seed=9)
    mask = jnp.asarray(r.random(512) < 0.5)
    want = jnp.where(mask[:, None], arr.at[rows, idx].set(val), arr)
    assert np.array_equal(np.asarray(ring_write(arr, idx, val, mask)),
                          np.asarray(want))


@pytest.mark.parametrize("n_nonzero", [10, 300])
def test_compact_scatter_add_is_at_add(n_nonzero):
    """Below the compaction capacity (64) and above it (full-scatter
    fallback) the deposit equals .at[].add."""
    r = np.random.default_rng(n_nonzero)
    n = 1024
    w = np.zeros(n, np.float32)
    w[r.choice(n, n_nonzero, replace=False)] = r.random(n_nonzero) + 0.1
    idx = jnp.asarray(r.integers(0, 200, n), jnp.int32)
    base = jnp.zeros(200, jnp.float32)
    got = compact_scatter_add(base, idx, jnp.asarray(w), 64)
    want = base.at[idx].add(jnp.asarray(w))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


def test_shifted_window_table_matches_numpy():
    v = np.arange(10, dtype=np.float32)
    w = np.asarray(shifted_window_table(jnp.asarray(v), 3))
    want = np.stack([v[np.clip(np.arange(10) + d, 0, 9)]
                     for d in range(-3, 4)], axis=1)
    assert np.array_equal(w, want)


def test_lookups_trace_under_jit():
    """The helpers run inside jitted code (the engine's loop body)."""
    t = _table((171, 7), seed=10)
    idx = jnp.arange(64, dtype=jnp.int32) % 171
    got = jax.jit(onehot_gather)(t, idx)
    assert np.array_equal(_bits(got), _bits(t[idx]))
