"""Parity tests for the all-pairs Möller–Trumbore intersector (ops/mt_matmul.py)
against the gather traversal and the all-pairs scan oracle.

Contract under test: identical hit decisions to intersect.ray_triangle
(EPSILON determinant rejection, u,v barycentric bounds, t > EPSILON,
strictly-nearest hit, lowest-index ties — raytrace.wgsl:78-116) up to f32
re-association on boundary-of-validity pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_pathtracer as pt
from tpu_pathtracer.ops.intersect import brute_force_intersect, bvh_intersect
from tpu_pathtracer.ops.mt_matmul import (
    mt_intersect,
    mt_intersect_diff,
    ray_features,
    triangle_columns,
)


def random_rays(rng, n, spread=3.0):
    ro = jnp.asarray(rng.uniform(-spread, spread, (n, 3)), jnp.float32)
    rd = rng.normal(size=(n, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, jnp.asarray(rd, jnp.float32)


def random_tri_pos(rng, n, spread=2.0):
    base = rng.uniform(-spread, spread, (n, 1, 3))
    verts = base + rng.uniform(-0.8, 0.8, (n, 3, 3))
    return jnp.asarray(verts.reshape(n, 9), jnp.float32)


def assert_hits_match(ha, hb, *, label=""):
    """Hit parity up to f32 re-association: masks equal, t close everywhere.
    A lane may pick a *different* triangle only when the two reported t's
    are a near-tie (a ray crossing a shared mesh edge hits both adjacent
    triangles at the same t; the traversal breaks ties by visit order, MT
    by lowest index).  u/v are compared on same-triangle lanes only."""
    np.testing.assert_array_equal(np.asarray(ha.hit), np.asarray(hb.hit), err_msg=label)
    m = np.asarray(ha.hit)
    ta, tb = np.asarray(ha.t)[m], np.asarray(hb.t)[m]
    np.testing.assert_allclose(ta, tb, rtol=2e-5, atol=1e-6, err_msg=label)
    same = np.asarray(ha.tri)[m] == np.asarray(hb.tri)[m]
    assert same.mean() > 0.98, f"{label}: too many tri mismatches ({(~same).sum()})"
    np.testing.assert_allclose(
        ta[~same], tb[~same], rtol=1e-6, atol=1e-6,
        err_msg=f"{label}: tri mismatch without a t tie",
    )
    np.testing.assert_allclose(np.asarray(ha.u)[m][same], np.asarray(hb.u)[m][same], rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(ha.v)[m][same], np.asarray(hb.v)[m][same], rtol=1e-4, atol=2e-5)


def test_features_and_columns_reproduce_mt():
    """phi(ray) @ columns(tri) reproduces (a, u*a, v*a, t*a) from the
    sequential Möller–Trumbore formulation."""
    rng = np.random.default_rng(7)
    tri = random_tri_pos(rng, 64)
    ro, rd = random_rays(rng, 128)
    dets = jnp.einsum("rk,kcn->rcn", ray_features(ro, rd), triangle_columns(tri))

    from tpu_pathtracer.ops.vecmath import cross, dot

    p0, p1, p2 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    e1, e2 = p1 - p0, p2 - p0
    # sequential MT per pair (broadcast rays x tris)
    h = cross(rd[:, None, :], e2[None])
    a = dot(e1[None], h)
    s = ro[:, None, :] - p0[None]
    ua = dot(s, h)
    q = cross(s, e1[None])
    va = dot(rd[:, None, :], q)
    ta = dot(e2[None], q)
    np.testing.assert_allclose(dets[:, 0], a, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dets[:, 1], ua, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dets[:, 2], va, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dets[:, 3], ta, rtol=1e-4, atol=1e-4)


def test_mt_vs_brute_force_random_soup():
    rng = np.random.default_rng(3)
    tri = random_tri_pos(rng, 200)
    ro, rd = random_rays(rng, 512)

    from tpu_pathtracer.scene.types import Triangles

    tris = Triangles(
        p0=tri[:, 0:3], p1=tri[:, 3:6], p2=tri[:, 6:9],
        n0=tri[:, 0:3], n1=tri[:, 3:6], n2=tri[:, 6:9],
        material=jnp.zeros((200,), jnp.int32),
    )
    ha = jax.jit(mt_intersect)(tri, ro, rd)
    hb = jax.jit(brute_force_intersect)(tris, ro, rd)
    assert np.asarray(ha.hit).sum() > 50, "test needs real hits"
    assert_hits_match(ha, hb, label="mt vs brute force")


def test_mt_vs_bvh_default_scene():
    scene = pt.default_scene().compile()
    rng = np.random.default_rng(11)
    # rays aimed at the scene from a shell
    ro = rng.normal(size=(1024, 3))
    ro = ro / np.linalg.norm(ro, axis=1, keepdims=True) * 4.0 + [0, 1, 0]
    target = rng.uniform(-1, 1, (1024, 3)) * [1.5, 0.8, 1.5] + [0, 0.5, 0]
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro = jnp.asarray(ro, jnp.float32)
    rd = jnp.asarray(rd, jnp.float32)

    ha = jax.jit(mt_intersect)(scene.packed.tri_pos, ro, rd)
    hb = jax.jit(bvh_intersect)(scene.packed.nodes, scene.packed.tri_pos, ro, rd)
    assert np.asarray(ha.hit).sum() > 500
    assert_hits_match(ha, hb, label="mt vs bvh traversal")


def test_mt_chunked_equals_unchunked():
    rng = np.random.default_rng(5)
    tri = random_tri_pos(rng, 300)  # not a multiple of chunk -> padding path
    ro, rd = random_rays(rng, 256)
    ha = mt_intersect(tri, ro, rd, chunk=64)
    hb = mt_intersect(tri, ro, rd, chunk=4096)
    np.testing.assert_array_equal(np.asarray(ha.hit), np.asarray(hb.hit))
    np.testing.assert_array_equal(np.asarray(ha.tri), np.asarray(hb.tri))
    np.testing.assert_array_equal(np.asarray(ha.t), np.asarray(hb.t))


def test_mt_empty_and_degenerate():
    rng = np.random.default_rng(9)
    ro, rd = random_rays(rng, 64)
    h = mt_intersect(jnp.zeros((0, 9), jnp.float32), ro, rd)
    assert not np.asarray(h.hit).any()
    # all-degenerate (zero) triangles: a == 0 everywhere -> no hits
    h = mt_intersect(jnp.zeros((16, 9), jnp.float32), ro, rd)
    assert not np.asarray(h.hit).any()
    assert np.all(np.asarray(h.tri) == -1)


def test_mt_lowest_index_tie_break():
    """Two identical triangles: the lower index must win (the
    brute_force_intersect tie contract)."""
    tri1 = jnp.asarray(
        [[-1, -1, -2, 1, -1, -2, 0, 1, -2]], jnp.float32
    )
    tri = jnp.concatenate([tri1, tri1], axis=0)
    ro = jnp.zeros((4, 3), jnp.float32)
    rd = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32), (4, 1))
    h = mt_intersect(tri, ro, rd)
    assert np.asarray(h.hit).all()
    assert np.all(np.asarray(h.tri) == 0)
    # also across a chunk boundary
    h = mt_intersect(tri, ro, rd, chunk=1)
    assert np.all(np.asarray(h.tri) == 0)


def test_resolve_intersector():
    from tpu_pathtracer.ops.trace import MT_AUTO_MAX_TRIS, resolve_intersector

    assert resolve_intersector("auto", 2048) == "mt"  # tests run on the CPU
    assert resolve_intersector("auto", MT_AUTO_MAX_TRIS + 1) == "bvh8"
    assert resolve_intersector("bvh", 16) == "bvh"
    assert resolve_intersector("mt_pallas", 16, "gpu") == "mt_pallas"
    assert resolve_intersector("bvh8", 16) == "bvh8"
    with pytest.raises(ValueError):
        resolve_intersector("nope", 16)


def test_mt_diff_gradients_match_bvh_diff():
    """Gradients of sum(t) w.r.t. ray origins agree with the detached-replay
    BVH path (both use replay_hit on the same chosen triangles)."""
    from tpu_pathtracer.ops.intersect import bvh_intersect_diff

    scene = pt.default_scene().compile()
    rng = np.random.default_rng(13)
    ro = jnp.asarray(np.tile([[0.0, 1.0, 4.0]], (64, 1)), jnp.float32)
    target = rng.uniform(-0.5, 0.5, (64, 3)) + [0, 0.5, 0]
    rd = jnp.asarray(target, jnp.float32) - ro
    rd = rd / jnp.linalg.norm(rd, axis=1, keepdims=True)

    def loss_mt(ro_):
        h = mt_intersect_diff(scene.packed.tri_pos, ro_, rd)
        return jnp.where(h.hit, h.t, 0.0).sum()

    def loss_bvh(ro_):
        h = bvh_intersect_diff(scene.packed.nodes, scene.packed.tri_pos, ro_, rd)
        return jnp.where(h.hit, h.t, 0.0).sum()

    g_mt = jax.grad(loss_mt)(ro)
    g_bvh = jax.grad(loss_bvh)(ro)
    np.testing.assert_allclose(np.asarray(g_mt), np.asarray(g_bvh), rtol=1e-5, atol=1e-6)
    assert np.abs(np.asarray(g_mt)).sum() > 0
