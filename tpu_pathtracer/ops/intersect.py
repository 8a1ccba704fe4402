"""Ray-primitive intersection and vectorized BVH traversal (jnp path).

Semantics follow the reference kernels exactly:
  * Möller–Trumbore with EPSILON determinant rejection and t > EPSILON
    acceptance (reference: src/passes/shaders/raytrace.wgsl:78-116),
  * slab ray-AABB test with the parallel-axis containment check
    (raytrace.wgsl:118-152),
  * iterative stack traversal, MAX_STACK_SIZE=64, overflow terminates that
    ray with its best hit so far (raytrace.wgsl:154-203), left child pushed
    before right (so right is visited first), nearest hit wins with strict <.

This module is the portable XLA implementation: every ray carries its own
traversal state inside a `lax.while_loop`, with gathers for node and
triangle data.  The loops' exit predicates depend on data, so on the GPU
XLA copies them to the host on every iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .vecmath import EPSILON, INF, cross, dot

MAX_STACK_SIZE = 64  # raytrace.wgsl:8


class Hit(NamedTuple):
    """SoA hit record over the ray axis (reference Hit struct + barycentrics)."""

    hit: jax.Array  # (R,) bool
    t: jax.Array  # (R,) f32 (INF on miss)
    tri: jax.Array  # (R,) i32 triangle index (-1 on miss)
    u: jax.Array  # (R,) f32 barycentric for p1
    v: jax.Array  # (R,) f32 barycentric for p2


def ray_triangle(ro, rd, p0, p1, p2):
    """Möller–Trumbore, vectorized over matching leading shapes.

    Returns (valid (.,), t, u, v).  No normal interpolation here; callers
    interpolate from barycentrics (raytrace.wgsl:105-112).
    """
    edge1 = p1 - p0
    edge2 = p2 - p0
    h = cross(rd, edge2)
    a = dot(edge1, h)
    non_parallel = jnp.abs(a) >= EPSILON
    f = jnp.float32(1.0) / a
    s = ro - p0
    u = f * dot(s, h)
    q = cross(s, edge1)
    v = f * dot(rd, q)
    t = f * dot(edge2, q)
    valid = (
        non_parallel
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPSILON)
    )
    return valid, t, u, v


def ray_aabb(ro, rd, bmin, bmax):
    """Slab test (raytrace.wgsl:118-152), vectorized; returns bool mask.

    The reference's per-axis early-outs collapse to: all parallel axes must
    contain the origin, and the accumulated tmax >= max(0, tmin).
    """
    parallel = jnp.abs(rd) < EPSILON
    inside = (ro >= bmin) & (ro <= bmax)
    ok_parallel = jnp.all(~parallel | inside, axis=-1)

    safe_rd = jnp.where(parallel, jnp.float32(1.0), rd)
    t1 = (bmin - ro) / safe_rd
    t2 = (bmax - ro) / safe_rd
    tnear = jnp.where(parallel, -INF, jnp.minimum(t1, t2))
    tfar = jnp.where(parallel, INF, jnp.maximum(t1, t2))
    tmin = jnp.max(tnear, axis=-1)
    tmax = jnp.min(tfar, axis=-1)
    return ok_parallel & (tmax >= jnp.maximum(jnp.float32(0.0), tmin))


def ray_aabb_t(ro, rd, bmin, bmax):
    """Slab test that also returns the entry distance tmin (for ordered/
    pruned traversal).  Hit condition identical to `ray_aabb`."""
    parallel = jnp.abs(rd) < EPSILON
    inside = (ro >= bmin) & (ro <= bmax)
    ok_parallel = jnp.all(~parallel | inside, axis=-1)

    safe_rd = jnp.where(parallel, jnp.float32(1.0), rd)
    t1 = (bmin - ro) / safe_rd
    t2 = (bmax - ro) / safe_rd
    tnear = jnp.where(parallel, -INF, jnp.minimum(t1, t2))
    tfar = jnp.where(parallel, INF, jnp.maximum(t1, t2))
    tmin = jnp.max(tnear, axis=-1)
    tmax = jnp.min(tfar, axis=-1)
    return ok_parallel & (tmax >= jnp.maximum(jnp.float32(0.0), tmin)), tmin


def bvh_intersect(nodes, tri_pos, ro, rd):
    """Stackless skip-link BVH traversal (the XLA fast path).

    nodes: (K, 8) packed skip-link nodes, tri_pos: (N, 9) packed vertices
    (see scene.types.PackedGeometry — a single wide gather per step compiles
    and runs far faster than per-field gathers);  ro, rd: (R, 3).
    Returns Hit.

    Per-ray state is a single node pointer.  Node AABBs whose entry distance
    exceeds the current best hit are skipped (safe pruning: no triangle in
    that subtree can win).  Nearest-hit result matches the reference's stack
    traversal (raytrace.wgsl:154-203) up to exact-t ties, without the 64-deep
    stack-overflow failure mode.
    """
    R = ro.shape[0]
    K = nodes.shape[0]
    if K == 0:  # empty-scene early out (raytrace.wgsl:205-211)
        z = jnp.zeros((R,), jnp.float32)
        return Hit(jnp.zeros((R,), bool), jnp.full((R,), INF), jnp.full((R,), -1, jnp.int32), z, z)

    # ray-derived zeros taint the literal inits with the rays' value-
    # varying-axes type (shard_map check_vma; numeric no-op)
    zf = ro[:, 0] * jnp.float32(0.0)
    zi = zf.astype(jnp.int32)
    init = (
        zi,  # ptr
        jnp.full((R,), INF) + zf,
        jnp.full((R,), -1, jnp.int32) + zi,
        zf,
        zf,
    )

    def cond(state):
        return jnp.any(state[0] < K)

    def body(state):
        ptr, best_t, best_tri, best_u, best_v = state
        active = ptr < K
        p = jnp.where(active, ptr, 0)

        nd = nodes[p]  # (R, 8) single gather
        box_hit, box_tmin = ray_aabb_t(ro, rd, nd[:, 0:3], nd[:, 3:6])
        box_hit = box_hit & active & (box_tmin < best_t)

        tri_idx = jax.lax.bitcast_convert_type(nd[:, 6], jnp.int32)
        miss = jax.lax.bitcast_convert_type(nd[:, 7], jnp.int32)
        is_leaf = tri_idx >= 0
        td = tri_pos[jnp.clip(tri_idx, 0, tri_pos.shape[0] - 1)]  # (R, 9)
        valid, t, u, v = ray_triangle(ro, rd, td[:, 0:3], td[:, 3:6], td[:, 6:9])
        take = box_hit & is_leaf & valid & (t < best_t)
        best_t = jnp.where(take, t, best_t)
        best_tri = jnp.where(take, tri_idx, best_tri)
        best_u = jnp.where(take, u, best_u)
        best_v = jnp.where(take, v, best_v)

        descend = box_hit & ~is_leaf
        nxt = jnp.where(descend, p + 1, miss)
        ptr = jnp.where(active, nxt, ptr)
        return ptr, best_t, best_tri, best_u, best_v

    _, best_t, best_tri, best_u, best_v = jax.lax.while_loop(cond, body, init)
    return Hit(best_tri >= 0, best_t, best_tri, best_u, best_v)


def replay_hit(tri_pos, ro, rd, h):
    """Analytically recompute (t, u, v) for an already-chosen triangle.

    Path-replay style (SURVEY.md §7 layer E): the discrete *choice* of
    triangle comes from a non-differentiable intersector run on
    stop-gradient inputs; (t, u, v) are then recomputed analytically for
    the chosen triangle with the Möller–Trumbore math, which IS
    differentiable w.r.t. ray origin/direction and the packed vertex
    positions.  Gradients treat the visibility function as locally constant
    (correct almost everywhere; silhouette terms are out of scope, as in
    standard path-replay backprop).

    Divisions are guarded on miss lanes so reverse-mode never forms inf*0.
    """
    tri_safe = jnp.clip(h.tri, 0, tri_pos.shape[0] - 1)
    td = tri_pos[tri_safe]
    p0, p1, p2 = td[:, 0:3], td[:, 3:6], td[:, 6:9]

    edge1 = p1 - p0
    edge2 = p2 - p0
    hvec = cross(rd, edge2)
    a = dot(edge1, hvec)
    # On a hit lane the traversal accepted this triangle, so |a| >= EPSILON;
    # miss lanes carry clamped garbage — pin their denominator to 1.
    a_safe = jnp.where(h.hit & (jnp.abs(a) >= EPSILON), a, jnp.float32(1.0))
    f = jnp.float32(1.0) / a_safe
    s = ro - p0
    u = f * dot(s, hvec)
    q = cross(s, edge1)
    v = f * dot(rd, q)
    t = f * dot(edge2, q)

    t = jnp.where(h.hit, t, INF)
    u = jnp.where(h.hit, u, 0.0)
    v = jnp.where(h.hit, v, 0.0)
    return Hit(h.hit, t, h.tri, u, v)


def bvh_intersect_diff(nodes, tri_pos, ro, rd):
    """Differentiable BVH intersection: detached traversal + `replay_hit`."""
    h = bvh_intersect(
        jax.lax.stop_gradient(nodes),
        jax.lax.stop_gradient(tri_pos),
        jax.lax.stop_gradient(ro),
        jax.lax.stop_gradient(rd),
    )
    return replay_hit(tri_pos, ro, rd, h)


def bvh_intersect_stack(bvh, triangles, ro, rd):
    """Stack-based BVH traversal for a batch of rays — the literal analogue
    of the reference's traversal incl. its 64-deep overflow early-exit.
    Kept as a semantic cross-check for `bvh_intersect`.

    bvh: scene.types.FlatBVH;  triangles: scene.types.Triangles;
    ro, rd: (R, 3).  Returns Hit.
    """
    R = ro.shape[0]
    n_nodes = bvh.left.shape[0]
    if n_nodes == 0:  # empty-scene early out (raytrace.wgsl:205-211)
        z = jnp.zeros((R,), jnp.float32)
        return Hit(jnp.zeros((R,), bool), jnp.full((R,), INF), jnp.full((R,), -1, jnp.int32), z, z)

    root_hit = ray_aabb(ro, rd, bvh.node_min[0], bvh.node_max[0])

    zi = (ro[:, 0] * jnp.float32(0.0)).astype(jnp.int32)  # vma taint
    stack = jnp.zeros((R, MAX_STACK_SIZE), jnp.int32) + zi[:, None]
    sp = jnp.where(root_hit, 1, 0).astype(jnp.int32)
    lanes = jax.lax.broadcasted_iota(jnp.int32, (1, MAX_STACK_SIZE), 1)

    zf = zi.astype(jnp.float32)
    init = (
        stack,
        sp,
        jnp.full((R,), INF) + zf,
        jnp.full((R,), -1, jnp.int32) + zi,
        zf,
        zf,
    )

    def cond(state):
        return jnp.any(state[1] > 0)

    def body(state):
        stack, sp, best_t, best_tri, best_u, best_v = state
        # Overflow rule: a ray whose stack reached MAX_STACK_SIZE terminates
        # with its best-so-far hit (raytrace.wgsl:167-171).
        sp = jnp.where(sp >= MAX_STACK_SIZE, 0, sp)
        active = sp > 0

        top = jnp.clip(sp - 1, 0, MAX_STACK_SIZE - 1)
        node = jnp.take_along_axis(stack, top[:, None], axis=1)[:, 0]
        node = jnp.where(active, node, 0)
        sp = jnp.where(active, sp - 1, sp)

        leaf = bvh.is_leaf[node] == 1

        # --- leaf path: test the one triangle ---------------------------
        tri_idx = bvh.tri[node]
        tri_safe = jnp.clip(tri_idx, 0, triangles.p0.shape[0] - 1)
        valid, t, u, v = ray_triangle(
            ro,
            rd,
            triangles.p0[tri_safe],
            triangles.p1[tri_safe],
            triangles.p2[tri_safe],
        )
        take = active & leaf & valid & (t < best_t)
        best_t = jnp.where(take, t, best_t)
        best_tri = jnp.where(take, tri_idx, best_tri)
        best_u = jnp.where(take, u, best_u)
        best_v = jnp.where(take, v, best_v)

        # --- internal path: AABB-test children, push hits ---------------
        internal = active & ~leaf
        left = bvh.left[node]
        right = bvh.right[node]
        lsafe = jnp.clip(left, 0, n_nodes - 1)
        rsafe = jnp.clip(right, 0, n_nodes - 1)
        push_l = internal & (left >= 0) & ray_aabb(ro, rd, bvh.node_min[lsafe], bvh.node_max[lsafe])
        push_r = internal & (right >= 0) & ray_aabb(ro, rd, bvh.node_min[rsafe], bvh.node_max[rsafe])

        slot_l = jnp.clip(sp, 0, MAX_STACK_SIZE - 1)
        stack = jnp.where(
            (lanes == slot_l[:, None]) & push_l[:, None], left[:, None], stack
        )
        sp = sp + push_l.astype(jnp.int32)
        slot_r = jnp.clip(sp, 0, MAX_STACK_SIZE - 1)
        stack = jnp.where(
            (lanes == slot_r[:, None]) & push_r[:, None], right[:, None], stack
        )
        sp = sp + push_r.astype(jnp.int32)

        return stack, sp, best_t, best_tri, best_u, best_v

    _, _, best_t, best_tri, best_u, best_v = jax.lax.while_loop(cond, body, init)
    return Hit(best_tri >= 0, best_t, best_tri, best_u, best_v)


def brute_force_intersect(triangles, ro, rd, num_valid=None):
    """All-pairs reference intersector: every ray against every triangle.

    O(R*N) — used for tiny scenes and as a second oracle for the BVH path.
    Tie-breaking matches traversal order-independence: strictly nearest t wins;
    equal-t ties resolve to the lowest triangle index.
    """
    def per_tri(carry, tri):
        best_t, best_tri, best_u, best_v, idx = carry
        p0, p1, p2 = tri
        valid, t, u, v = ray_triangle(ro, rd, p0, p1, p2)
        take = valid & (t < best_t)
        return (
            jnp.where(take, t, best_t),
            jnp.where(take, idx, best_tri),
            jnp.where(take, u, best_u),
            jnp.where(take, v, best_v),
            idx + 1,
        ), None

    R = ro.shape[0]
    init = (
        jnp.full((R,), INF),
        jnp.full((R,), -1, jnp.int32),
        jnp.zeros((R,), jnp.float32),
        jnp.zeros((R,), jnp.float32),
        jnp.int32(0),
    )
    (best_t, best_tri, best_u, best_v, _), _ = jax.lax.scan(
        per_tri, init, (triangles.p0, triangles.p1, triangles.p2)
    )
    return Hit(best_tri >= 0, best_t, best_tri, best_u, best_v)


def _map_ray_batches(fn, ro, rd, batch: int):
    """Run `fn(ro, rd) -> Hit` over sub-batches of the ray axis via lax.map.

    The traversal while_loops run in lockstep over their whole batch: ONE
    worst-case ray (e.g. a shell-crossing ray visiting thousands of boxes)
    stalls every lane for its full path.  Sub-batching bounds the damage to
    one batch, but the batches run one after another (lax.map), each with
    its own loop.  On an H100 the 100K-triangle stress frame (512^2, 6
    bounces) took 178.5 / 141.0 / 214.0 ms at batches of 16384 / 65536 /
    all rays, so `bvh_fat_intersect` defaults to 65536 (PERF.md).
    """
    R = ro.shape[0]
    if batch <= 0 or R <= batch or R % batch:
        return fn(ro, rd)
    n = R // batch
    hits = jax.lax.map(
        lambda ab: fn(ab[0], ab[1]),
        (ro.reshape(n, batch, 3), rd.reshape(n, batch, 3)),
    )
    return Hit(*(x.reshape(R) for x in hits))


def bvh_fat_intersect(fat_nodes, ro, rd, *, max_leaf: int = 8,
                      ray_batch: int = 65536):
    if ray_batch:
        fn = lambda a, b: bvh_fat_intersect(fat_nodes, a, b,
                                            max_leaf=max_leaf, ray_batch=0)
        return _map_ray_batches(fn, ro, rd, ray_batch)
    return _bvh_fat_intersect_impl(fat_nodes, ro, rd, max_leaf=max_leaf)


def _bvh_fat_intersect_impl(fat_nodes, ro, rd, *, max_leaf: int = 8):
    """Skip-link traversal over the fat-leaf BVH (accel.bvh.links_to_fat).

    Each visited node costs ONE wide gather (box + up to `max_leaf` inlined
    triangles) instead of a node gather plus a triangle gather per leaf —
    and the fat tree has ~max_leaf x fewer nodes, so the gather-bound
    lockstep step count shrinks accordingly.
    Triangle tests inside a leaf are vectorized over the leaf axis (cheap
    elementwise work).  Nearest hit wins; within a leaf the lowest row index takes
    exact-t ties; across nodes the first-visited node wins (the traversal-
    order convention of `bvh_intersect`).  `Hit.tri` indexes the PACKED
    (DFS leaf order) triangle rows like the other intersectors.
    """
    R = ro.shape[0]
    K = fat_nodes.shape[0]
    L = max_leaf
    if K == 0:  # empty-scene early out (raytrace.wgsl:205-211)
        z = jnp.zeros((R,), jnp.float32)
        return Hit(jnp.zeros((R,), bool), jnp.full((R,), INF),
                   jnp.full((R,), -1, jnp.int32), z, z)

    zf = ro[:, 0] * jnp.float32(0.0)  # vma taint (shard_map check_vma)
    zi = zf.astype(jnp.int32)
    init = (
        zi,  # ptr
        jnp.full((R,), INF) + zf,
        jnp.full((R,), -1, jnp.int32) + zi,
        zf,
        zf,
    )
    lanes = jax.lax.broadcasted_iota(jnp.int32, (1, L), 1)
    rows_r = jnp.arange(R)

    def cond(state):
        return jnp.any(state[0] < K)

    def body(state):
        ptr, best_t, best_tri, best_u, best_v = state
        active = ptr < K
        p = jnp.where(active, ptr, 0)

        row = fat_nodes[p]  # (R, 9 + 9L) single gather
        box_hit, box_tmin = ray_aabb_t(ro, rd, row[:, 0:3], row[:, 3:6])
        box_hit = box_hit & active & (box_tmin < best_t)

        miss = jax.lax.bitcast_convert_type(row[:, 6], jnp.int32)
        tstart = jax.lax.bitcast_convert_type(row[:, 7], jnp.int32)
        count = jax.lax.bitcast_convert_type(row[:, 8], jnp.int32)
        is_leaf = count > 0

        tp = row[:, 9:].reshape(R, L, 9)
        valid, t, u, v = ray_triangle(
            ro[:, None, :], rd[:, None, :],
            tp[..., 0:3], tp[..., 3:6], tp[..., 6:9],
        )
        usable = valid & (lanes < count[:, None]) & (box_hit & is_leaf)[:, None]
        t = jnp.where(usable, t, INF)
        j = jnp.argmin(t, axis=1)
        t_j = t[rows_r, j]
        take = t_j < best_t
        best_t = jnp.where(take, t_j, best_t)
        best_tri = jnp.where(take, tstart + j.astype(jnp.int32), best_tri)
        best_u = jnp.where(take, u[rows_r, j], best_u)
        best_v = jnp.where(take, v[rows_r, j], best_v)

        nxt = jnp.where(box_hit & ~is_leaf, p + 1, miss)
        ptr = jnp.where(active, nxt, ptr)
        return ptr, best_t, best_tri, best_u, best_v

    _, best_t, best_tri, best_u, best_v = jax.lax.while_loop(cond, body, init)
    return Hit(best_tri >= 0, best_t, best_tri, best_u, best_v)
