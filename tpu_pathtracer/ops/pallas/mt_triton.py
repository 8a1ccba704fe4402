"""Fused all-pairs Möller–Trumbore intersection for NVIDIA GPUs.

A Pallas kernel lowered through Triton.  The plain XLA path
(ops/mt_matmul.py) forms an (R, 4, C) block of pair determinants per
triangle chunk in device memory and reads it back for the nearest-hit
epilogue.  This kernel never stores that block:

  * one program owns `block_rays` rays; their nine features
    (ro, rd, ro x rd) stay in registers, with a running nearest hit
    (t, tri, u, v) per ray and lane;
  * it loops over the compact (19, N) coefficient table
    (mt_matmul.triangle_coef_rows) in `block_tris`-wide chunks, which
    `num_stages` pipelines; padding triangles are all-zero, so a == 0 and
    they never hit;
  * the loop body is elementwise: the reduction over the lanes runs once,
    after the last chunk;
  * each determinant is an explicit float32 multiply-add chain on the CUDA
    cores.  `pl.dot` is not used: the contraction depth is 10, below the
    tensor cores' minimum, and TF32 would break the geometric predicates.

Arithmetic follows `mt_intersect` term for term: every determinant
accumulates its non-zero phi features in phi order (the order a
sequential-K float32 product sums them) and the epilogue is `_epilogue`'s.
Each lane takes a hit with a strict `<` in increasing triangle order; the
final nearest hit is min(t), then the lowest index attaining it, so exact
ties resolve to the lowest triangle index (the contract of
brute_force_intersect).

There is no culling: every ray meets every triangle, which bounds the
kernel to scenes of a few thousand triangles (ops/trace.MT_AUTO_MAX_TRIS).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..intersect import Hit
from ..mt_matmul import COEF_ROWS, triangle_coef_rows
from ..vecmath import EPSILON, INF, cross

_BIG_INDEX = np.int32(2**31 - 1)


def _kernel(feat_ref, coef_ref, t_ref, tri_ref, u_ref, v_ref, *,
            block_rays: int, block_tris: int, n_chunks: int):
    rows = pl.ds(pl.program_id(0) * block_rays, block_rays)
    rox, roy, roz, rdx, rdy, rdz, cx, cy, cz = (
        feat_ref[k, rows][:, None] for k in range(9)
    )
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, block_tris), 1)

    def body(c, best):
        # Per (ray, lane) running nearest hit: lane j sees triangles j,
        # j + block_tris, ... in increasing order, so a strict `<` keeps
        # the lowest index on exact ties within the lane.
        best_t, best_tri, best_u, best_v = best
        start = c * block_tris
        cols = pl.ds(pl.multiple_of(start, block_tris), block_tris)
        k = [coef_ref[j, cols][None, :] for j in range(COEF_ROWS)]

        a = rdx * k[0] + rdy * k[1] + rdz * k[2]
        ua = rdx * k[3] + rdy * k[4] + rdz * k[5] + cx * k[6] + cy * k[7] + cz * k[8]
        va = (rdx * k[9] + rdy * k[10] + rdz * k[11]
              + cx * k[12] + cy * k[13] + cz * k[14])
        ta = k[15] + rox * k[16] + roy * k[17] + roz * k[18]

        # mt_matmul._epilogue, term for term.
        abs_a = jnp.abs(a)
        sa = jnp.sign(a)
        us = ua * sa
        vs = va * sa
        nonpar = abs_a >= EPSILON
        valid = (
            nonpar
            & (us >= 0.0)
            & (us <= abs_a)
            & (vs >= 0.0)
            & (us + vs <= abs_a)
            & (ta * sa > EPSILON * abs_a)
        )
        f = jnp.float32(1.0) / jnp.where(nonpar, a, jnp.float32(1.0))
        t = jnp.where(valid, ta * f, INF)
        take = t < best_t
        return (
            jnp.where(take, t, best_t),
            jnp.where(take, start + lane, best_tri),
            jnp.where(take, ua * f, best_u),
            jnp.where(take, va * f, best_v),
        )

    shape = (block_rays, block_tris)
    init = (jnp.full(shape, INF, jnp.float32),
            jnp.full(shape, -1, jnp.int32),
            jnp.zeros(shape, jnp.float32),
            jnp.zeros(shape, jnp.float32))
    best_t, best_tri, best_u, best_v = jax.lax.fori_loop(
        0, n_chunks, body, init)
    # Nearest over the lanes: min(t), then the lowest index attaining it.
    t_min = jnp.min(best_t, axis=1)
    j = jnp.min(jnp.where(best_t == t_min[:, None], best_tri, _BIG_INDEX),
                axis=1)
    sel = best_tri == j[:, None]
    t_ref[...] = t_min
    tri_ref[...] = j
    u_ref[...] = jnp.sum(jnp.where(sel, best_u, 0.0), axis=1)
    v_ref[...] = jnp.sum(jnp.where(sel, best_v, 0.0), axis=1)


def mt_intersect_triton(tri_pos, ro, rd, *, block_rays: int = 32,
                        block_tris: int = 32, interpret: bool = False):
    """All-pairs MT intersection in one fused GPU kernel; returns `Hit`.

    tri_pos: (N, 9) packed vertices; ro, rd: (R, 3).  R and N need not be
    multiples of the block sizes (both are zero-padded: a zero ray and a
    zero triangle both give a == 0, a guaranteed miss).  Block sizes must
    be powers of two (Triton); the defaults, with 2 warps and 2 pipeline
    stages, were the fastest of a sweep on an H100 (PERF.md).
    `interpret=True` runs the kernel in the Pallas interpreter, for tests
    on the CPU."""
    R = ro.shape[0]
    N = tri_pos.shape[0]
    if N == 0:  # empty-scene early out (raytrace.wgsl:205-211)
        z = jnp.zeros((R,), jnp.float32)
        return Hit(jnp.zeros((R,), bool), z + INF,
                   jnp.full((R,), -1, jnp.int32), z, z)
    n_chunks = -(-N // block_tris)
    coef = triangle_coef_rows(tri_pos)
    coef = jnp.pad(coef, ((0, 0), (0, n_chunks * block_tris - N)))
    r_pad = -(-R // block_rays) * block_rays
    feat = jnp.concatenate([ro, rd, cross(ro, rd)], axis=1).T  # (9, R)
    feat = jnp.pad(feat, ((0, 0), (0, r_pad - R)))

    # Under shard_map the outputs vary over the mesh axes the inputs vary
    # over (check_vma wants that stated).
    vma = jax.typeof(feat).vma | jax.typeof(coef).vma
    ray_block = pl.BlockSpec((block_rays,), lambda i: (i,))
    kernel = functools.partial(
        _kernel, block_rays=block_rays, block_tris=block_tris,
        n_chunks=n_chunks,
    )
    t, tri, u, v = pl.pallas_call(
        kernel,
        grid=(r_pad // block_rays,),
        in_specs=[
            pl.BlockSpec(feat.shape, lambda i: (0, 0)),
            pl.BlockSpec(coef.shape, lambda i: (0, 0)),
        ],
        out_specs=[ray_block] * 4,
        out_shape=[
            jax.ShapeDtypeStruct((r_pad,), dtype, vma=vma)
            for dtype in (jnp.float32, jnp.int32, jnp.float32, jnp.float32)
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=2, num_stages=2),
        interpret=interpret,
        name="mt_intersect_triton",
    )(feat, coef)
    t, tri, u, v = t[:R], tri[:R], u[:R], v[:R]
    return Hit(tri >= 0, t, tri, u, v)
