"""Wavefront path tracing with ray sorting + chunked traversal.

The megakernel (ops/trace.trace_rays) keeps every ray in one vectorized
while_loop: each traversal step runs until the WORST lane finishes, so one
deep ray stalls the whole batch.  The wavefront formulation breaks each
bounce into stages (SURVEY.md §7 layer C, BASELINE.json configs[3]):

  1. *sort*: order rays by a coherence key — terminated rays sink to the
     tail, live rays group by direction octant + origin cell,
  2. *intersect*: `lax.map` over fixed-size chunks, each chunk running its
     own BVH while_loop.  A chunk of terminated rays exits after one check;
     a chunk of coherent rays shares a similar traversal depth.  This is a
     static-shape analogue of wavefront queue compaction: the worst-lane
     cost is paid per chunk instead of per frame,
  3. *shade*: the exact megakernel bounce math (trace.bounce_shade), so
     radiance and RNG streams are IDENTICAL to the megakernel — sorting
     only permutes lanes, every per-ray stream is preserved.

Status: no render path dispatches this module; it is the semantically
exact wavefront formulation (bit-identical images), verified on the CPU,
kept as the base for ray compaction on the GPU (ROADMAP R6).  Its speed on
the GPU is not measured.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import camera as camera_ops
from . import rng
from .intersect import Hit, bvh_intersect
from .trace import accumulate, bounce_shade  # noqa: F401  (accumulate re-export)

INF = jnp.float32(np.inf)


def _coherence_key(ro, rd, active, scene_min, scene_max, cells: int = 8):
    """Sort key: inactive rays last; active rays grouped by direction octant
    then origin cell (a coarse grid over the scene bounds)."""
    octant = (
        (rd[:, 0] >= 0).astype(jnp.uint32)
        + 2 * (rd[:, 1] >= 0).astype(jnp.uint32)
        + 4 * (rd[:, 2] >= 0).astype(jnp.uint32)
    )
    extent = jnp.maximum(scene_max - scene_min, 1e-6)
    cell_f = (ro - scene_min) / extent * cells
    cell = jnp.clip(cell_f.astype(jnp.int32), 0, cells - 1).astype(jnp.uint32)
    cell_id = (cell[:, 0] * cells + cell[:, 1]) * cells + cell[:, 2]
    key = octant * jnp.uint32(cells**3) + cell_id
    return jnp.where(active, key, jnp.uint32(0xFFFFFFFF))


def _chunked_intersect(nodes, tri_pos, ro, rd, active, chunk: int):
    """BVH-intersect in independent fixed-size chunks via lax.map.

    Inactive rays are pre-terminated (their traversal pointer starts at the
    sentinel), so fully-inactive chunks cost one loop-condition check.
    """
    R = ro.shape[0]
    n_chunks = R // chunk

    def one(args):
        ro_c, rd_c, act_c = args
        h = _masked_intersect(nodes, tri_pos, ro_c, rd_c, act_c)
        return h.hit, h.t, h.tri, h.u, h.v

    hit, t, tri, u, v = jax.lax.map(
        one,
        (
            ro.reshape(n_chunks, chunk, 3),
            rd.reshape(n_chunks, chunk, 3),
            active.reshape(n_chunks, chunk),
        ),
    )
    return Hit(hit.reshape(R), t.reshape(R), tri.reshape(R),
               u.reshape(R), v.reshape(R))


def _masked_intersect(nodes, tri_pos, ro, rd, active):
    """bvh_intersect with inactive lanes starting at the end sentinel."""
    from .intersect import ray_aabb_t, ray_triangle

    R = ro.shape[0]
    K = nodes.shape[0]
    if K == 0:
        z = jnp.zeros((R,), jnp.float32)
        return Hit(jnp.zeros((R,), bool), jnp.full((R,), INF),
                   jnp.full((R,), -1, jnp.int32), z, z)

    init = (
        jnp.where(active, 0, K).astype(jnp.int32),  # inactive: already done
        jnp.full((R,), INF),
        jnp.full((R,), -1, jnp.int32),
        jnp.zeros((R,), jnp.float32),
        jnp.zeros((R,), jnp.float32),
    )

    def cond(state):
        return jnp.any(state[0] < K)

    def body(state):
        ptr, best_t, best_tri, best_u, best_v = state
        live = ptr < K
        p = jnp.where(live, ptr, 0)
        nd = nodes[p]
        box_hit, box_tmin = ray_aabb_t(ro, rd, nd[:, 0:3], nd[:, 3:6])
        box_hit = box_hit & live & (box_tmin < best_t)
        tri_idx = jax.lax.bitcast_convert_type(nd[:, 6], jnp.int32)
        miss = jax.lax.bitcast_convert_type(nd[:, 7], jnp.int32)
        is_leaf = tri_idx >= 0
        td = tri_pos[jnp.clip(tri_idx, 0, tri_pos.shape[0] - 1)]
        valid, t, u, v = ray_triangle(ro, rd, td[:, 0:3], td[:, 3:6], td[:, 6:9])
        take = box_hit & is_leaf & valid & (t < best_t)
        best_t = jnp.where(take, t, best_t)
        best_tri = jnp.where(take, tri_idx, best_tri)
        best_u = jnp.where(take, u, best_u)
        best_v = jnp.where(take, v, best_v)
        nxt = jnp.where(box_hit & ~is_leaf, p + 1, miss)
        ptr = jnp.where(live, nxt, ptr)
        return ptr, best_t, best_tri, best_u, best_v

    _, best_t, best_tri, best_u, best_v = jax.lax.while_loop(cond, body, init)
    return Hit(best_tri >= 0, best_t, best_tri, best_u, best_v)


def trace_rays_wavefront(scene, params, ro, rd, seed, *, max_bounces: int,
                         chunk: int = 2048, sort_rays: bool = True,
                         env_importance: bool = False):
    """Wavefront trace: per-bounce sort -> chunked intersect -> shade.

    Bit-compatible with `trace_rays` (same RNG streams per ray; sorting only
    permutes lane order and is undone on return).
    """
    R = ro.shape[0]
    pad = (-R) % chunk
    if pad:
        # pad with inactive rays (they pre-terminate in the chunked
        # intersect, costing one loop-condition check per chunk)
        z3 = jnp.zeros((pad, 3), jnp.float32)
        ro = jnp.concatenate([ro, z3])
        rd = jnp.concatenate([rd, jnp.broadcast_to(
            jnp.array([0.0, 0.0, 1.0], jnp.float32), (pad, 3))])
        seed = jnp.concatenate([seed, jnp.zeros((pad,), seed.dtype)])
    RP = R + pad

    nodes = scene.packed.nodes
    scene_min = nodes[0, 0:3]
    scene_max = nodes[0, 3:6]

    incoming = jnp.zeros((RP, 3), jnp.float32)
    color = jnp.ones((RP, 3), jnp.float32)
    active = (jnp.arange(RP) < R) if pad else jnp.ones((RP,), bool)
    # lane[i] = original ray id currently living in slot i
    lane = jnp.arange(RP, dtype=jnp.int32)

    state = (ro, rd, incoming, color, seed, active, lane)

    def body(_, state):
        ro, rd, incoming, color, seed, active, lane = state
        if sort_rays:
            key = _coherence_key(ro, rd, active, scene_min, scene_max)
            order = jnp.argsort(key)
            ro, rd, incoming, color, seed, active, lane = (
                ro[order], rd[order], incoming[order], color[order],
                seed[order], active[order], lane[order],
            )
        hit = _chunked_intersect(nodes, scene.packed.tri_pos, ro, rd, active,
                                 chunk)
        ro, rd, incoming, color, seed, active = bounce_shade(
            scene, params, hit, (ro, rd, incoming, color, seed, active),
            env_importance=env_importance,
        )
        return ro, rd, incoming, color, seed, active, lane

    ro, rd, incoming, color, seed, active, lane = jax.lax.fori_loop(
        0, max_bounces, body, state
    )
    # un-permute back to original ray order, dropping any padding lanes
    inv = jnp.zeros((RP,), jnp.int32).at[lane].set(jnp.arange(RP, dtype=jnp.int32))
    inv = inv[:R]
    return incoming[inv], seed[inv]


def render_frame_wavefront(scene, params, *, width: int, height: int,
                           aspect: float, samples_per_frame: int = 1,
                           max_bounces: int = 4, chunk: int = 2048,
                           sort_rays: bool = True,
                           env_importance: bool = False):
    """`render_frame` on the wavefront trace path.  Same image semantics as
    the megakernel renderer (identical per-pixel RNG streams)."""
    R = width * height
    xs = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1)
    ys = jax.lax.broadcasted_iota(jnp.int32, (height, width), 0)
    uv = jnp.stack(
        [xs.astype(jnp.float32) / np.float32(width),
         ys.astype(jnp.float32) / np.float32(height)],
        axis=-1,
    ).reshape(R, 2)
    pixel_index = (xs + ys * width).reshape(R)
    seed = rng.pixel_seed(pixel_index, params.frame)

    base_o, base_d = camera_ops.camera_rays(params.camera, uv, jnp.float32(aspect))
    resolution = jnp.array([width, height], jnp.float32)

    def sample_body(_, carry):
        seed, acc = carry
        seed, o, d = camera_ops.apply_dof(seed, base_o, base_d, params.camera,
                                          resolution)
        light, seed = trace_rays_wavefront(
            scene, params, o, d, seed, max_bounces=max_bounces, chunk=chunk,
            sort_rays=sort_rays, env_importance=env_importance,
        )
        return seed, acc + light

    _, acc = jax.lax.fori_loop(
        0, samples_per_frame, sample_body, (seed, jnp.zeros((R, 3), jnp.float32))
    )
    return (acc / np.float32(samples_per_frame)).reshape(height, width, 3)
