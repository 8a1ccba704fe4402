"""All-pairs Möller–Trumbore ray/triangle intersection as a bilinear form.

The reference's hot loop is a divergent per-thread BVH stack walk
(reference: src/passes/shaders/raytrace.wgsl:154-203).  This module is the
plain XLA formulation of the all-pairs alternative, and the reference the
fused GPU kernel (ops/pallas/mt_triton.py) is checked against.

Möller–Trumbore (raytrace.wgsl:78-116) is a bilinear form in the ray: with
the 10-feature vector

    phi(ray) = [1, ro, rd, ro x rd]                         (R, 10)

the four determinants of EVERY ray x triangle pair are one matmul against a
per-triangle coefficient table (scalar triple-product identities):

    a   = det            = rd . (e2 x e1)
    u*a = s . h          = e2 . (ro x rd) - rd . (e2 x p0)
    v*a = rd . q         = -e1 . (ro x rd) - rd . (p0 x e1)
    t*a = e2 . q         = ro . (e1 x e2) - e2 . (p0 x e1)

(e1 = p1 - p0, e2 = p2 - p0, s = ro - p0, h = rd x e2, q = s x e1).  The
validity conditions and the nearest-hit argmin are a short elementwise
epilogue.  No gathers, no sorting, no per-ray divergence.

Semantics match `intersect.ray_triangle` exactly in exact arithmetic
(EPSILON determinant rejection, u,v in [0,1], u+v <= 1, t > EPSILON,
strictly-nearest hit, lowest triangle index on exact ties); float rounding
differs from the sequential formulation only by re-association.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .intersect import Hit
from .vecmath import EPSILON, INF, cross

# True float32 for the K=10 contraction (on the GPU, HIGHEST means IEEE
# float32 with no TF32): the determinants feed geometric predicates, so a
# reduced-precision product is not acceptable.
_PRECISION = jax.lax.Precision.HIGHEST

# Rows of `triangle_coef_rows`, in phi-feature order within each
# determinant: a = rd.n; u*a = rd.(-e2xp0) + (ro x rd).e2;
# v*a = rd.(-p0xe1) + (ro x rd).(-e1); t*a = const + ro.(e1xe2).
COEF_ROWS = 19


def _coef_parts(tri_pos):
    """The non-zero MT coefficient vectors of each triangle, (N, 3) each
    except the (N,) t*a constant."""
    p0 = tri_pos[:, 0:3]
    e1 = tri_pos[:, 3:6] - p0
    e2 = tri_pos[:, 6:9] - p0
    p0xe1 = cross(p0, e1)
    return dict(
        n=cross(e2, e1),  # a = rd . n
        ua_rd=-cross(e2, p0),
        ua_rxd=e2,
        va_rd=-p0xe1,
        va_rxd=-e1,
        ta_const=-jnp.einsum("nk,nk->n", e2, p0xe1, precision=_PRECISION),
        ta_ro=cross(e1, e2),
    )


def triangle_coef_rows(tri_pos):
    """The 19 non-zero rows of `triangle_columns` as one (19, N) f32 table
    (row order: see COEF_ROWS).  The fused kernel streams this compact
    table instead of the zero-padded (10, 4, N) one."""
    c = _coef_parts(tri_pos)
    return jnp.concatenate(
        [c["n"].T, c["ua_rd"].T, c["ua_rxd"].T, c["va_rd"].T,
         c["va_rxd"].T, c["ta_const"][None, :], c["ta_ro"].T],
        axis=0,
    )


def triangle_columns(tri_pos):
    """Pack per-triangle MT coefficients: tri_pos (N, 9) -> (10, 4, N) f32.

    Column blocks along axis 1 are [a, u*a, v*a, t*a]; rows along axis 0 are
    the phi features [1, ro(3), rd(3), ro x rd(3)].  Cheap (O(N) elementwise)
    and differentiable w.r.t. the vertex positions, so it is (re)computed
    inside the jitted trace step — XLA hoists it out of the bounce loop.
    """
    c = _coef_parts(tri_pos)
    N = tri_pos.shape[0]
    zeros3 = jnp.zeros((N, 3), tri_pos.dtype)
    zeros1 = jnp.zeros((N,), tri_pos.dtype)

    # (N, 10) per output column, then stack -> (N, 4, 10) -> (10, 4, N)
    col_a = jnp.concatenate([zeros1[:, None], zeros3, c["n"], zeros3], axis=1)
    col_ua = jnp.concatenate(
        [zeros1[:, None], zeros3, c["ua_rd"], c["ua_rxd"]], axis=1)
    col_va = jnp.concatenate(
        [zeros1[:, None], zeros3, c["va_rd"], c["va_rxd"]], axis=1)
    col_ta = jnp.concatenate(
        [c["ta_const"][:, None], c["ta_ro"], zeros3, zeros3], axis=1)

    cols = jnp.stack([col_a, col_ua, col_va, col_ta], axis=1)  # (N, 4, 10)
    return jnp.transpose(cols, (2, 1, 0))  # (10, 4, N)


def ray_features(ro, rd):
    """phi(ray): (R, 3),(R, 3) -> (R, 10) = [1, ro, rd, ro x rd]."""
    ones = jnp.ones((ro.shape[0], 1), ro.dtype)
    return jnp.concatenate([ones, ro, rd, cross(ro, rd)], axis=1)


def _epilogue(dets, base, best):
    """Validity + nearest-hit update for one chunk of pair determinants.

    dets: (R, 4, C) = [a, u*a, v*a, t*a]; base: global index of column 0.
    best: (best_t, best_tri, best_u, best_v) running state.
    Matches raytrace.wgsl:78-116 conditions; divides only to recover
    (t, u, v) — sign-correct because every comparison multiplies through
    by sign(a) instead of dividing by a.
    """
    best_t, best_tri, best_u, best_v = best
    a = dets[:, 0, :]
    ua = dets[:, 1, :]
    va = dets[:, 2, :]
    ta = dets[:, 3, :]

    abs_a = jnp.abs(a)
    sa = jnp.sign(a)
    us = ua * sa  # u * |a|
    vs = va * sa
    ts = ta * sa
    valid = (
        (abs_a >= EPSILON)
        & (us >= 0.0)
        & (us <= abs_a)
        & (vs >= 0.0)
        & (us + vs <= abs_a)
        & (ts > EPSILON * abs_a)
    )
    f = jnp.float32(1.0) / jnp.where(abs_a >= EPSILON, a, jnp.float32(1.0))
    t = jnp.where(valid, ta * f, INF)  # (R, C)

    # Nearest hit in this chunk; jnp.argmin takes the first (lowest-index)
    # minimum, and strict < against the carry keeps the global lowest index
    # on exact ties — the contract of intersect.brute_force_intersect.
    j = jnp.argmin(t, axis=1)  # (R,)
    rows = jnp.arange(t.shape[0])
    t_j = t[rows, j]
    take = t_j < best_t
    idx = base + j.astype(jnp.int32)
    best_t = jnp.where(take, t_j, best_t)
    best_tri = jnp.where(take, idx, best_tri)
    best_u = jnp.where(take, (ua * f)[rows, j], best_u)
    best_v = jnp.where(take, (va * f)[rows, j], best_v)
    return best_t, best_tri, best_u, best_v


def mt_intersect(tri_pos, ro, rd, *, chunk: int = 512):
    """All-pairs MT intersection in plain XLA; returns `intersect.Hit`.

    tri_pos: (N, 9) packed vertices; ro, rd: (R, 3).  Triangle chunking
    bounds the (R, 4*C) intermediate; each chunk is one
    (R, 10) @ (10, 4C) matmul + epilogue, carried through a fori_loop.
    Degenerate all-zero padding triangles have a == 0 and never hit
    (scene.types padding contract).
    """
    R = ro.shape[0]
    N = tri_pos.shape[0]
    if N == 0:  # empty-scene early out (raytrace.wgsl:205-211)
        z = jnp.zeros((R,), jnp.float32)
        return Hit(jnp.zeros((R,), bool), jnp.full((R,), INF),
                   jnp.full((R,), -1, jnp.int32), z, z)

    phi = ray_features(ro, rd)  # (R, 10)
    cols = triangle_columns(tri_pos)  # (10, 4, N)

    # ray-derived zeros taint the literal inits with the rays' value-
    # varying-axes type (shard_map check_vma; numeric no-op)
    zf = ro[:, 0] * jnp.float32(0.0)
    zi = zf.astype(jnp.int32)
    init = (
        jnp.full((R,), INF) + zf,
        jnp.full((R,), -1, jnp.int32) + zi,
        zf,
        zf,
    )

    if N <= chunk:
        dets = jnp.einsum(
            "rk,kcn->rcn", phi, cols, precision=_PRECISION
        )  # (R, 4, N)
        best = _epilogue(dets, jnp.int32(0), init)
    else:
        if N % chunk:
            pad = chunk - N % chunk
            cols = jnp.pad(cols, ((0, 0), (0, 0), (0, pad)))
            N += pad
        n_chunks = N // chunk
        cols = cols.reshape(10, 4, n_chunks, chunk)

        def body(i, best):
            c = jax.lax.dynamic_index_in_dim(cols, i, axis=2, keepdims=False)
            dets = jnp.einsum("rk,kcn->rcn", phi, c, precision=_PRECISION)
            return _epilogue(dets, i * chunk, best)

        best = jax.lax.fori_loop(0, n_chunks, body, init)

    best_t, best_tri, best_u, best_v = best
    return Hit(best_tri >= 0, best_t, best_tri, best_u, best_v)


def mt_intersect_diff(tri_pos, ro, rd, *, chunk: int = 512):
    """Differentiable variant: detached argmin, analytically replayed
    (t, u, v) — same path-replay contract as intersect.bvh_intersect_diff."""
    from .intersect import replay_hit

    h = mt_intersect(
        jax.lax.stop_gradient(tri_pos),
        jax.lax.stop_gradient(ro),
        jax.lax.stop_gradient(rd),
        chunk=chunk,
    )
    return replay_hit(tri_pos, ro, rd, h)
