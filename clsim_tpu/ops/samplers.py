"""Reparameterized random-value samplers.

Equivalents of the reference's I3CLSimRandomValue hierarchy
(public/clsim/random_value/*.h).  Every sampler is an inverse-CDF transform
of a uniform variate, so gradients flow from the sample to the distribution
parameters (the counter-based-RNG reparameterization the BASELINE north star
requires).  All samplers broadcast over array-shaped uniforms.
"""

from __future__ import annotations

import jax.numpy as jnp


def henyey_greenstein_cos(g, u):
    """cos(theta) ~ HG(g).  Inverse CDF: with s = 2u-1,
    cos = (1 + g^2 - ((1-g^2)/(1+g s))^2) / (2 g)
    (reference random_value/I3CLSimRandomValueHenyeyGreenstein.cxx:52-70).
    Falls back to the isotropic limit for |g| ~ 0."""
    s = 2.0 * u - 1.0
    g_safe = jnp.where(jnp.abs(g) < 1e-6, 1e-6, g)
    frac = (1.0 - g_safe * g_safe) / (1.0 + g_safe * s)
    cos = (1.0 + g_safe * g_safe - frac * frac) / (2.0 * g_safe)
    cos = jnp.where(jnp.abs(g) < 1e-6, s, cos)
    return jnp.clip(cos, -1.0, 1.0)


def simplified_liu_cos(g, u):
    """cos(theta) ~ simplified Liu (SAM): cos = 2*u^beta - 1,
    beta = (1-g)/(1+g)
    (reference random_value/I3CLSimRandomValueSimplifiedLiu.cxx:52-61)."""
    beta = (1.0 - g) / (1.0 + g)
    return jnp.clip(2.0 * u ** beta - 1.0, -1.0, 1.0)


def mixed_cos(g, liu_fraction, u_select, u_sample):
    """Mixture: with prob. liu_fraction sample simplified-Liu, else HG
    (reference random_value/I3CLSimRandomValueMixed.cxx; assembled for
    IceCube in python/MakeIceCubeMediumProperties.py:183-187)."""
    liu = simplified_liu_cos(g, u_sample)
    hg = henyey_greenstein_cos(g, u_sample)
    return jnp.where(u_select < liu_fraction, liu, hg)


def rayleigh_cos(u):
    """Rayleigh scattering angle sampling via the standard cubic solve:
    cos = b - 1/b with b = cbrt(q + sqrt(q^2+d^3)) ... using the closed form
    employed for water phase functions
    (reference random_value/I3CLSimRandomValueRayleighScatteringCosAngle.cxx)."""
    b = 0.835
    p = 1.0 / 0.835
    q = (b + 3.0) * (u - 0.5) / b
    d = q * q + p * p * p
    u1 = -q + jnp.sqrt(d)
    u1 = jnp.sign(u1) * jnp.abs(u1) ** (1.0 / 3.0)
    v1 = -q - jnp.sqrt(d)
    v1 = jnp.sign(v1) * jnp.abs(v1) ** (1.0 / 3.0)
    return jnp.clip(u1 + v1, -1.0, 1.0)


def normal_box_muller(u1, u2):
    """Standard normal via Box-Muller (the reference's
    I3CLSimRandomValueNormalDistribution)."""
    r = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u1, 1e-38)))
    return r * jnp.cos(2.0 * jnp.pi * u2)


# ---------------------------------------------------------------------------
# Tabulated pdf -> linear-interpolated inverse CDF
# (equivalent of I3CLSimRandomValueInterpolatedDistribution)
# ---------------------------------------------------------------------------

def build_interpolated_dist(x, y):
    """Precompute the sampling tables for a piecewise-linear pdf given by
    support points x (ascending) and non-negative densities y.

    Matches the reference's trapezoidal construction
    (random_value/I3CLSimRandomValueInterpolatedDistribution.cxx:140-177):
      acu[j] = normalized trapezoid CDF at x[j], beta[j] = normalized density.
    Returns (x, acu, beta) as jnp arrays; differentiable w.r.t. y.
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    widths = x[1:] - x[:-1]
    segs = widths * (y[1:] + y[:-1]) / 2.0
    acu = jnp.concatenate([jnp.zeros((1,), y.dtype), jnp.cumsum(segs)])
    total = acu[-1]
    return x, acu / total, y / total


def sample_interpolated_dist(tables, u):
    """Inverse-CDF sample from tables built by build_interpolated_dist.

    Solves the quadratic within the located segment exactly as the reference
    does (…InterpolatedDistribution.cxx:84-135), so sampled values (given the
    same uniforms) agree to float precision."""
    x, acu, beta = tables
    n = x.shape[0]
    k = jnp.clip(jnp.searchsorted(acu, u, side="right") - 1, 0, n - 2)
    b = beta[k]
    x0 = x[k]
    slope = (beta[k + 1] - b) / (x[k + 1] - x0)
    dy = u - acu[k]

    eps = 1e-20
    both_zero = (jnp.abs(b) < eps) & (jnp.abs(slope) < eps)
    b_zero = jnp.abs(b) < eps
    s_zero = jnp.abs(slope) < eps

    safe_slope = jnp.where(s_zero, 1.0, slope)
    safe_b = jnp.where(b_zero, 1.0, b)

    r_b_zero = x0 + jnp.sqrt(jnp.maximum(2.0 * dy / safe_slope, 0.0))
    r_s_zero = x0 + dy / safe_b
    r_full = x0 + (jnp.sqrt(jnp.maximum(
        dy * (2.0 * safe_slope) / (safe_b * safe_b) + 1.0, 0.0)) - 1.0) * safe_b / safe_slope

    out = jnp.where(both_zero, x0,
                    jnp.where(b_zero, r_b_zero,
                              jnp.where(s_zero, r_s_zero, r_full)))
    return out


def sample_interpolated_fast(x, acu, beta, u):
    """sample_interpolated_dist with the segment coefficients fetched by
    ops.lookup.onehot_gather, for use inside the propagation loop;
    identical math."""
    from .lookup import onehot_gather
    n = x.shape[0]
    k = jnp.clip(jnp.sum((acu <= u[..., None]).astype(jnp.int32), axis=-1) - 1,
                 0, n - 2)
    seg = jnp.stack([x[:-1], x[1:], beta[:-1], beta[1:], acu[:-1]], axis=1)
    rows = onehot_gather(seg, k)
    x0, x1, b, b1, acu0 = (rows[..., i] for i in range(5))
    slope = (b1 - b) / (x1 - x0)
    dy = u - acu0
    eps = 1e-20
    s_zero = jnp.abs(slope) < eps
    b_zero = jnp.abs(b) < eps
    safe_slope = jnp.where(s_zero, 1.0, slope)
    safe_b = jnp.where(b_zero, 1.0, b)
    r_full = x0 + (jnp.sqrt(jnp.maximum(
        dy * 2.0 * safe_slope / (safe_b * safe_b) + 1.0, 0.0)) - 1.0) * safe_b / safe_slope
    r_bz = x0 + jnp.sqrt(jnp.maximum(2.0 * dy / safe_slope, 0.0))
    r_sz = x0 + dy / safe_b
    return jnp.where(b_zero & s_zero, x0,
                     jnp.where(b_zero, r_bz, jnp.where(s_zero, r_sz, r_full)))
