"""Intersection unit tests + BVH traversal cross-checks
(reference: raytrace.wgsl:78-211)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_pathtracer.ops.intersect import (
    bvh_intersect,
    bvh_intersect_stack,
    brute_force_intersect,
    ray_aabb,
    ray_triangle,
)
from tpu_pathtracer.scene.host import Material, Mesh, Scene


def _v(*rows):
    return jnp.asarray(np.array(rows, np.float32))


def test_ray_triangle_hit_and_miss():
    p0, p1, p2 = _v([-1, -1, 0]), _v([1, -1, 0]), _v([0, 1, 0])
    ro = _v([0, 0, 5], [0, 0, 5], [5, 5, 5])
    rd = _v([0, 0, -1], [0, 0, 1], [0, 0, -1])
    valid, t, u, v = ray_triangle(ro, rd, p0, p1, p2)
    valid, t = np.asarray(valid), np.asarray(t)
    assert valid[0] and np.isclose(t[0], 5.0)
    assert not valid[1]  # pointing away
    assert not valid[2]  # misses laterally


def test_ray_triangle_barycentrics():
    p0, p1, p2 = _v([0, 0, 0]), _v([1, 0, 0]), _v([0, 1, 0])
    ro = _v([0.25, 0.25, 1.0])
    rd = _v([0, 0, -1])
    valid, t, u, v = ray_triangle(ro, rd, p0, p1, p2)
    assert np.asarray(valid)[0]
    assert np.isclose(np.asarray(u)[0], 0.25, atol=1e-6)
    assert np.isclose(np.asarray(v)[0], 0.25, atol=1e-6)


def test_ray_triangle_parallel_determinant():
    # Ray in the triangle's plane -> |det| < eps -> miss (raytrace.wgsl:86-88)
    p0, p1, p2 = _v([0, 0, 0]), _v([1, 0, 0]), _v([0, 1, 0])
    ro = _v([-1, 0.2, 0.0])
    rd = _v([1, 0, 0])
    valid, *_ = ray_triangle(ro, rd, p0, p1, p2)
    assert not np.asarray(valid)[0]


def test_ray_aabb_cases():
    bmin, bmax = _v([-1, -1, -1]), _v([1, 1, 1])
    ro = _v([0, 0, 5], [0, 0, 5], [0, 5, 0.5], [0, 0, 0], [5, 0, 0])
    rd = _v([0, 0, -1], [0, 0, 1], [0, -1, 0], [0, 0, 1], [0, 0, 1])
    hit = np.asarray(ray_aabb(ro, rd, bmin, bmax))
    assert hit[0]  # straight in
    assert not hit[1]  # pointing away
    assert hit[2]  # from above
    assert hit[3]  # origin inside
    assert not hit[4]  # parallel outside the slab (raytrace.wgsl:129-133)


def _random_soup_scene(n=200, seed=0):
    rs = np.random.RandomState(seed)
    base = rs.uniform(-2, 2, (n, 3)).astype(np.float32)
    e1 = rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    e2 = rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    pos = np.stack([base, base + e1, base + e2], axis=1).reshape(-1, 3)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (pos.shape[0], 1))
    idx = np.arange(pos.shape[0]).reshape(-1, 3)
    sc = Scene()
    sc.add(Mesh(pos, nrm, idx, Material()))
    return sc.compile()


@pytest.mark.parametrize("nrays", [256])
def test_bvh_matches_brute_force(nrays):
    sd = _random_soup_scene()
    rs = np.random.RandomState(1)
    ro = jnp.asarray(rs.uniform(-3, 3, (nrays, 3)).astype(np.float32))
    rd = rs.randn(nrays, 3).astype(np.float32)
    rd = jnp.asarray(rd / np.linalg.norm(rd, axis=-1, keepdims=True))

    h_link = bvh_intersect(sd.packed.nodes, sd.packed.tri_pos, ro, rd)
    h_stack = bvh_intersect_stack(sd.bvh, sd.triangles, ro, rd)
    h_brute = brute_force_intersect(sd.triangles, ro, rd)

    # packed arrays are in BVH-DFS leaf order; tri_perm maps back to the
    # original Triangles order that brute force / the stack walker use
    perm = np.asarray(sd.packed.tri_perm)
    link_tri = np.asarray(h_link.tri)
    link_tri_orig = np.where(link_tri >= 0, perm[np.clip(link_tri, 0, len(perm) - 1)], -1)
    assert np.array_equal(np.asarray(h_link.hit), np.asarray(h_brute.hit))
    assert np.array_equal(np.asarray(h_link.t), np.asarray(h_brute.t))
    assert np.array_equal(link_tri_orig, np.asarray(h_brute.tri))
    assert np.array_equal(np.asarray(h_link.t), np.asarray(h_stack.t))
    assert np.array_equal(link_tri_orig, np.asarray(h_stack.tri))


def test_empty_scene_misses():
    sc = Scene()
    sd = sc.compile()
    ro = jnp.zeros((8, 3))
    rd = jnp.asarray(np.tile([[0, 0, -1]], (8, 1)).astype(np.float32))
    h = bvh_intersect(sd.packed.nodes, sd.packed.tri_pos, ro, rd)
    assert not np.asarray(h.hit).any()


@pytest.mark.parametrize("ray_batch", [128, 100, 65536])
def test_fat_bvh_ray_batches_match_one_batch(ray_batch):
    """Sub-batching the walk (lax.map over equal batches) gives the
    unbatched result bit for bit; a batch that does not divide the ray
    count, or exceeds it, runs as one batch."""
    from tpu_pathtracer.ops.intersect import bvh_fat_intersect

    sd = _random_soup_scene(n=200, seed=5)
    rs = np.random.RandomState(8)
    ro = jnp.asarray(rs.uniform(-3, 3, (512, 3)).astype(np.float32))
    rd = rs.randn(512, 3).astype(np.float32)
    rd = jnp.asarray(rd / np.linalg.norm(rd, axis=-1, keepdims=True))
    ref = bvh_fat_intersect(sd.packed.fat_nodes, ro, rd, ray_batch=0)
    got = bvh_fat_intersect(sd.packed.fat_nodes, ro, rd, ray_batch=ray_batch)
    assert np.asarray(ref.hit).sum() > 30
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fat_bvh_matches_skip_link():
    """bvh8 (fat-leaf, 8 triangles inlined per node row) vs the 1-tri-leaf
    skip-link walk: identical hit masks and distances; triangle choices may
    differ only on exact-t ties (shared mesh edges)."""
    from tpu_pathtracer.ops.intersect import bvh_fat_intersect

    sd = _random_soup_scene(n=300, seed=4)
    rs = np.random.RandomState(7)
    ro = jnp.asarray(rs.uniform(-3, 3, (512, 3)).astype(np.float32))
    rd = rs.randn(512, 3).astype(np.float32)
    rd = jnp.asarray(rd / np.linalg.norm(rd, axis=-1, keepdims=True))

    h_fat = bvh_fat_intersect(sd.packed.fat_nodes, ro, rd)
    h_ref = bvh_intersect(sd.packed.nodes, sd.packed.tri_pos, ro, rd)
    hf, hr = np.asarray(h_fat.hit), np.asarray(h_ref.hit)
    assert hf.sum() > 50
    np.testing.assert_array_equal(hf, hr)
    m = hf
    np.testing.assert_allclose(np.asarray(h_fat.t)[m], np.asarray(h_ref.t)[m],
                               rtol=2e-6, atol=1e-7)
    same = np.asarray(h_fat.tri)[m] == np.asarray(h_ref.tri)[m]
    assert same.mean() > 0.98, (~same).sum()
    # mismatches must be exact-t ties
    np.testing.assert_allclose(np.asarray(h_fat.t)[m][~same],
                               np.asarray(h_ref.t)[m][~same], rtol=1e-6)


def test_fat_bvh_default_scene_and_render():
    """End-to-end: the bvh8 intersector renders the default scene close to
    the mt default (same image up to tie-break edge pixels)."""
    import tpu_pathtracer as pt
    from tpu_pathtracer.ops.trace import render_frame
    from tpu_pathtracer.scene.envmap import gradient_sky
    from tpu_pathtracer.scene.types import Camera, RenderParams

    sd = pt.default_scene(gradient_sky(16, 32)).compile()
    cam = Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
    p = RenderParams.create(cam, frame=1)
    a = np.asarray(render_frame(sd, p, width=24, height=24, aspect=1.0,
                                max_bounces=2, intersector="bvh8"))
    b = np.asarray(render_frame(sd, p, width=24, height=24, aspect=1.0,
                                max_bounces=2, intersector="mt"))
    assert np.isfinite(a).all()
    # identical RNG streams; images agree except possibly tie-break pixels
    close = np.isclose(a, b, rtol=1e-4, atol=1e-4).all(axis=-1)
    assert close.mean() > 0.97, close.mean()
