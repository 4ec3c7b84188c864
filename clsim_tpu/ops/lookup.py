"""Table lookup / scatter primitives of the propagation loop.

Every in-loop table access in the engine goes through these helpers, so the
lookup strategy is one decision kept in one module.  They are written as
one-hot matrix products and iota-compare selects rather than per-lane
indexing; which form is faster on a given device is a measurement, not an
assumption, and every helper returns exactly what plain indexing returns
(tests/test_lookup.py checks that bit for bit).

  * onehot_gather     -- table rows by per-lane index via one-hot @ table
  * select_rows_exact -- table rows by per-lane index via a masked select-sum
  * masked_set        -- scatter-free .at[arange, idx].set via iota compare
  * ring_write        -- masked per-lane ring-buffer write via iota compare
  * interp_onehot     -- jnp.interp on a table fetched by onehot_gather
  * compact_scatter_add -- top_k-compacted histogram deposition: the only
    real scatter left, shrunk from N updates to the hit count
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def onehot_gather(table, idx):
    """table[idx] for per-lane idx via one-hot matmul.

    table: (L,) or (L, F); idx: (N,) int32 in [0, L).  Returns (N,) or (N, F)
    float32, bit-exact for values representable in f32.
    """
    squeeze = table.ndim == 1
    t = table[:, None] if squeeze else table
    oh = jax.nn.one_hot(idx, t.shape[0], dtype=jnp.bfloat16)
    out = _exact_select_dot(oh, t)
    return out[:, 0] if squeeze else out


def _bf16_split(t):
    """(hi, mid, lo) with hi + mid + lo == t exactly in f32 and each part
    exactly representable in bfloat16 (at most 8 significant bits).

    The parts are cut by masking mantissa bits, not by rounding through a
    bfloat16 convert: XLA may drop an f32 -> bf16 -> f32 round trip as
    "excess precision", which silently collapses such a split."""
    def keep_top8(x):
        b = jax.lax.bitcast_convert_type(x, jnp.uint32)
        return jax.lax.bitcast_convert_type(b & jnp.uint32(0xFFFF0000),
                                            jnp.float32)
    t = t.astype(jnp.float32)
    hi = keep_top8(t)
    rem = t - hi
    mid = keep_top8(rem)
    return hi, mid, rem - mid


def _exact_select_dot(oh, t):
    """oh @ t exact to f32 for a one-hot matrix, at any matmul precision.

    A float32 product at the default precision may round its inputs (to
    TF32's 10-bit mantissa on GPUs with tensor cores, to bfloat16 on other
    devices).  Every input here is exactly representable in bfloat16: the
    one-hot matrix and the three parts of _bf16_split.  Each output element
    of a part's product sums a single nonzero term, so it is exact, and
    (hi + mid) + lo reconstructs the f32 table value."""
    hi, mid, lo = (jnp.dot(oh, part.astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32)
                   for part in _bf16_split(t))
    return (hi + mid) + lo


def select_rows_exact(table, idx):
    """Bit-exact table[idx] via a masked select-sum.

    For small tables (S <= ~100, few features): one fused (N, S) comparison
    pass; exact f32 with no matmul involved (a row sums one nonzero term).
    Cost ~ O(N*S) elementwise ops, amortized across features by fusion.
    """
    squeeze = table.ndim == 1
    t = table[:, None] if squeeze else table
    S, F = t.shape
    cols = jax.lax.broadcasted_iota(jnp.int32, (idx.shape[0], S), 1)
    mask = cols == idx[:, None]
    outs = [jnp.sum(jnp.where(mask, t[None, :, f], 0.0), axis=1)
            for f in range(F)]
    out = jnp.stack(outs, axis=1)
    return out[:, 0] if squeeze else out


def masked_set(arr, idx, value):
    """arr.at[arange(N), idx].set(value) without a scatter: iota compare.
    arr: (N, S); idx: (N,); value scalar or (N,)."""
    S = arr.shape[1]
    cols = jax.lax.broadcasted_iota(jnp.int32, arr.shape, 1)
    mask = cols == idx[:, None]
    v = jnp.broadcast_to(jnp.asarray(value, arr.dtype), arr.shape)
    return jnp.where(mask, v, arr)


def ring_write(ring, pos, value, mask):
    """ring.at[arange(N), pos].set(value) where mask, scatter-free.
    ring: (N, K); pos: (N,); value: (N,); mask: (N,) bool."""
    K = ring.shape[1]
    cols = jax.lax.broadcasted_iota(jnp.int32, ring.shape, 1)
    sel = (cols == pos[:, None]) & mask[:, None]
    return jnp.where(sel, value[:, None], ring)


def interp_onehot(x, xp, fp):
    """jnp.interp(x, xp, fp) for uniform-or-not ascending xp, with the
    segment endpoints fetched by onehot_gather.
    xp, fp: (L,); x: (N,).  Clamps outside the range like jnp.interp."""
    L = xp.shape[0]
    k = jnp.clip(jnp.searchsorted(xp, x, side="right") - 1, 0, L - 2)
    # fetch (xp[k], xp[k+1], fp[k], fp[k+1]) in one matmul
    tab = jnp.stack([xp[:-1], xp[1:], fp[:-1], fp[1:]], axis=1)  # (L-1, 4)
    rows = onehot_gather(tab, k)
    x0, x1, f0, f1 = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]
    t = jnp.clip((x - x0) / jnp.maximum(x1 - x0, 1e-30), 0.0, 1.0)
    return f0 + t * (f1 - f0)


def shifted_window_table(values, k_radius):
    """(L, 2K+1) matrix W with W[l, K+d] = values[clip(l+d)] for d in [-K, K].
    Built once per jitted call (tiny); lets a single one-hot matmul fetch a
    photon's whole layer neighborhood."""
    L = values.shape[0]
    offs = jnp.arange(-k_radius, k_radius + 1)
    idx = jnp.clip(jnp.arange(L)[:, None] + offs[None, :], 0, L - 1)
    return values[idx]


def compact_scatter_add(target, flat_idx, weights, capacity,
                        fallback_full=True):
    """target.at[flat_idx].add(weights) where most weights are zero.

    Compacts the nonzero entries with top_k (capacity H) and scatters only
    those H updates.  If more than H lanes are nonzero and fallback_full is
    set, falls back to the full scatter inside a lax.cond (exact; only the
    taken branch executes).
    """
    n = weights.shape[0]
    if capacity <= 0 or capacity >= n:
        return target.at[flat_idx].add(weights, mode="drop")

    n_nonzero = jnp.sum((weights != 0.0).astype(jnp.int32))

    def compacted(t):
        w_top, lanes = jax.lax.top_k(weights, capacity)
        idx_top = flat_idx[lanes]
        return t.at[idx_top].add(w_top, mode="drop")

    def full(t):
        return t.at[flat_idx].add(weights, mode="drop")

    if fallback_full:
        return jax.lax.cond(n_nonzero <= capacity, compacted, full, target)
    return compacted(target)
