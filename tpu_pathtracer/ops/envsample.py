"""Environment-map sampling: equirect UV mapping, texture filtering, and CDF
importance sampling.

Reference behavior (src/passes/shaders/raytrace.wgsl:289-371):
  * ray -> UV with Y-axis rotation, phi = atan2(x, z), theta = asin(y)
    (raytrace.wgsl:289-313),
  * radiance texture sampled bilinearly (linear sampler, renderer.ts:112-121;
    WebGPU default clamp-to-edge addressing),
  * CDF texture sampled nearest (renderer.ts:123-130),
  * importance sampling via 8-step binary search over the marginal (v) then
    conditional (u) CDFs (raytrace.wgsl:315-349).  The reference ships this
    disabled (call commented out at raytrace.wgsl:398); we implement it as a
    first-class, optional path *with* the PDF correction the reference left
    commented (raytrace.wgsl:402-404).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from . import rng
from .vecmath import EPSILON

INVPI = np.float32(0.31830988618)  # raytrace.wgsl:4
INVTWOPI = np.float32(0.15915494309)  # raytrace.wgsl:5


def env_uv_from_ray(rd, rotation):
    """Equirect UV for (possibly non-unit) direction (raytrace.wgsl:289-313).

    Non-unit directions arise because the reference does not renormalize after
    the diffuse/specular mix (raytrace.wgsl:391); asin's clamp handles them.
    """
    cos_r = jnp.cos(rotation)
    sin_r = jnp.sin(rotation)
    dx = rd[..., 0] * cos_r - rd[..., 2] * sin_r
    dy = rd[..., 1]
    dz = rd[..., 0] * sin_r + rd[..., 2] * cos_r
    phi = jnp.arctan2(dx, dz)
    theta = jnp.arcsin(jnp.clip(dy, -1.0, 1.0))
    return jnp.stack([phi * INVTWOPI + 0.5, -theta * INVPI + 0.5], axis=-1)


def sample_bilinear(img, uv):
    """Bilinear texture fetch with clamp-to-edge; img (H, W, C), uv (..., 2)."""
    h, w = img.shape[0], img.shape[1]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    # clamp each tap independently of the other (clamp-to-edge addressing)
    x0 = jnp.clip(x0f.astype(jnp.int32), 0, w - 1)
    y0 = jnp.clip(y0f.astype(jnp.int32), 0, h - 1)
    x1 = jnp.clip(x0f.astype(jnp.int32) + 1, 0, w - 1)
    y1 = jnp.clip(y0f.astype(jnp.int32) + 1, 0, h - 1)
    c00 = img[y0, x0]
    c10 = img[y0, x1]
    c01 = img[y1, x0]
    c11 = img[y1, x1]
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def sample_nearest(img, uv):
    """Nearest texture fetch with clamp-to-edge; img (H, W) or (H, W, C)."""
    h, w = img.shape[0], img.shape[1]
    x = jnp.clip(jnp.floor(uv[..., 0] * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip(jnp.floor(uv[..., 1] * h).astype(jnp.int32), 0, h - 1)
    return img[y, x]


def env_radiance(env, uv):
    """getEnvironmentMapColor (raytrace.wgsl:369-371)."""
    return sample_bilinear(env.radiance, uv)


def pack_env_patches(radiance):
    """(H, W, 3) -> (H*W, 12) rows holding each texel's 2x2 bilinear patch
    [c(y,x), c(y,x+1), c(y+1,x), c(y+1,x+1)] with clamp-to-edge neighbors.

    One WIDE row gather then replaces the four narrow gathers of
    `sample_bilinear` in the bounce loop.  Built from `radiance` inside the
    jitted trace (differentiable, hoisted out of the bounce loop by XLA).
    """
    h, w = radiance.shape[0], radiance.shape[1]
    xs = jnp.minimum(jnp.arange(w) + 1, w - 1)
    ys = jnp.minimum(jnp.arange(h) + 1, h - 1)
    c00 = radiance
    c10 = radiance[:, xs]
    c01 = radiance[ys]
    c11 = radiance[ys][:, xs]
    return jnp.concatenate([c00, c10, c01, c11], axis=-1).reshape(h * w, 12)


def env_radiance_packed(patches, shape, uv):
    """Bilinear env fetch from `pack_env_patches` rows; bit-matches
    `sample_bilinear` (incl. its clamp-to-edge tap semantics: when the
    left/top tap clamps, both taps read the same texel, which the packed
    row reproduces by zeroing the fraction)."""
    h, w = shape
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    # when floor < 0 both original taps clamp to texel 0 -> fraction 0
    fx = jnp.where(x0f < 0, 0.0, x - x0f)[..., None]
    fy = jnp.where(y0f < 0, 0.0, y - y0f)[..., None]
    x0 = jnp.clip(x0f.astype(jnp.int32), 0, w - 1)
    y0 = jnp.clip(y0f.astype(jnp.int32), 0, h - 1)
    row = patches[y0 * w + x0]  # (..., 12) single gather
    top = row[..., 0:3] + (row[..., 3:6] - row[..., 0:3]) * fx
    bot = row[..., 6:9] + (row[..., 9:12] - row[..., 6:9]) * fx
    return top + (bot - top) * fy


def _invert_exclusive_cdf(cdf_at, target, size):
    """Exact inversion of an exclusive per-texel CDF.

    `cdf_at(i)` returns cdf[i] = P(texels < i) for integer i in [0, size);
    finds the texel x with cdf[x] <= target < cdf[x+1] by integer binary
    search, then places the sample uniformly inside the texel via the
    piecewise-linear fractional offset.  Returns (x (i32), coord f32 in
    [0, 1)).  This (not the reference's 8-step midpoint search over
    *nearest-sampled* cdf values, raytrace.wgsl:315-349, which concentrates
    each texel's probability mass onto its boundary) makes the sampler's
    density exactly `EnvironmentMap.sample_pdf` — required for the enabled
    L/pdf estimator to be unbiased.  The reference never ran its variant
    (shipped commented out, raytrace.wgsl:398).
    """
    shape = target.shape
    zi = (target * jnp.float32(0.0)).astype(jnp.int32)  # vma taint (check_vma)
    lo = zi  # invariant: cdf[lo] <= target
    hi = jnp.full(shape, size, jnp.int32) + zi  # invariant: target < cdf[hi] (cdf[size]=1)
    for _ in range(max(1, int(np.ceil(np.log2(max(size, 2)))))):
        mid = (lo + hi) // 2
        go_right = cdf_at(mid) <= target
        lo = jnp.where(go_right, mid, lo)
        hi = jnp.where(go_right, hi, mid)
    c_lo = cdf_at(lo)
    c_hi = jnp.where(lo + 1 < size, cdf_at(jnp.minimum(lo + 1, size - 1)), 1.0)
    width = jnp.maximum(c_hi - c_lo, EPSILON)
    frac = jnp.clip((target - c_lo) / width, 0.0, 1.0)
    return lo, (lo.astype(jnp.float32) + frac) / np.float32(size)


def env_importance_sample(env, seed):
    """CDF inversion sampling of the environment map: marginal over rows,
    then conditional over columns (tables from scene/envmap.build_cdf_tables,
    the vectorized port of renderer.ts:159-266).  Consumes 2 uniforms.
    Returns (seed, uv (..., 2)); the sample's density is
    `env.sample_pdf[texel]` exactly (see _invert_exclusive_cdf)."""
    seed, r1 = rng.rand(seed)
    seed, r2 = rng.rand(seed)
    h, w = env.height, env.width

    y, v = _invert_exclusive_cdf(lambda i: env.marginal_cdf[i, 0], r1, h)
    _, u = _invert_exclusive_cdf(lambda i: env.conditional_cdf[y, i], r2, w)
    return seed, jnp.stack([u, v], axis=-1)


def env_pdf(env, uv):
    """Sampling density at uv (nearest texel, floored).

    Returns the TRUE uv-measure density of `env_importance_sample`
    (env.sample_pdf), NOT the reference's packed pdf channel: the packed
    channel is the raw sin-weighted luminance (renderer.ts:253-266), which
    makes the L/pdf estimator biased — the reference shipped that consumer
    commented out (raytrace.wgsl:398-404) and never validated it.  With the
    real density the estimator is unbiased (tests/test_envmap.py)."""
    return jnp.maximum(sample_nearest(env.sample_pdf, uv), EPSILON)
