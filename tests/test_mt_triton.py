"""The fused GPU Möller–Trumbore kernel (ops/pallas/mt_triton.py) and the
intersector dispatch (ops/trace.resolve_intersector).

On the CPU the kernel runs in the Pallas interpreter (`interpret=True`) and
is held to the plain XLA intersector (ops/mt_matmul.mt_intersect), whose
arithmetic it follows term for term.  Tests marked `gpu` run the compiled
kernel; they skip where there is no card (`python chip_smoke.py` runs them
on one).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_pathtracer as pt
from tpu_pathtracer.ops import trace
from tpu_pathtracer.ops.intersect import bvh_intersect
from tpu_pathtracer.ops.mt_matmul import (
    mt_intersect,
    triangle_coef_rows,
    triangle_columns,
)
from tpu_pathtracer.ops.pallas.mt_triton import mt_intersect_triton
from tpu_pathtracer.scene.envmap import gradient_sky
from tpu_pathtracer.scene.types import Camera, RenderParams

kernel = partial(mt_intersect_triton, interpret=True)


def random_rays(rng, n, spread=3.0):
    ro = jnp.asarray(rng.uniform(-spread, spread, (n, 3)), jnp.float32)
    rd = rng.normal(size=(n, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, jnp.asarray(rd, jnp.float32)


def random_tri_pos(rng, n, spread=2.0):
    base = rng.uniform(-spread, spread, (n, 1, 3))
    verts = base + rng.uniform(-0.8, 0.8, (n, 3, 3))
    return jnp.asarray(verts.reshape(n, 9), jnp.float32)


def assert_close_tuv(ha, hb, m):
    """(t, u, v) within 1e-5 relative, with a floor of 1e-5 absolute below
    magnitude 1 (u, v are barycentrics in [0, 1]): both sides sum the same
    float32 terms and differ only in order and FMA contraction."""
    for f in ("t", "u", "v"):
        a = np.asarray(getattr(ha, f))[m]
        b = np.asarray(getattr(hb, f))[m]
        bad = np.abs(a - b) > 1e-5 * np.maximum(np.abs(a), 1.0)
        assert not bad.any(), f"{f}: {bad.sum()} lanes, e.g. {a[bad][:3]} vs {b[bad][:3]}"


def assert_same_hits(ha, hb, min_hits=0):
    """Same hit mask and triangle everywhere; (t, u, v) to float32
    re-association (`assert_close_tuv`)."""
    np.testing.assert_array_equal(np.asarray(ha.hit), np.asarray(hb.hit))
    m = np.asarray(ha.hit)
    assert m.sum() >= min_hits, f"test needs hits, got {m.sum()}"
    np.testing.assert_array_equal(np.asarray(ha.tri), np.asarray(hb.tri))
    assert_close_tuv(ha, hb, m)


@pytest.fixture(scope="module")
def default_scene_data():
    return pt.default_scene(gradient_sky(8, 16)).compile()


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")


# --- the kernel alone -------------------------------------------------------


@pytest.mark.parametrize(
    "n_rays,n_tris,block_rays,block_tris",
    [
        (300, 200, 128, 32),   # neither a multiple of its block
        (129, 33, 128, 32),    # one ray and one triangle past a block
        (1000, 700, 256, 64),  # several chunks, wider blocks
        (50, 1, 64, 16),       # fewer rays and triangles than one block
    ],
)
def test_kernel_matches_mt_random_soup(n_rays, n_tris, block_rays, block_tris):
    rng = np.random.default_rng(n_rays + n_tris)
    tri = random_tri_pos(rng, n_tris)
    ro, rd = random_rays(rng, n_rays)
    ha = mt_intersect(tri, ro, rd)
    hb = kernel(tri, ro, rd, block_rays=block_rays, block_tris=block_tris)
    assert hb.t.shape == (n_rays,) and hb.tri.dtype == jnp.int32
    assert_same_hits(ha, hb)


def test_kernel_default_scene_vs_bvh(default_scene_data):
    rng = np.random.default_rng(11)
    ro = rng.normal(size=(512, 3))
    ro = ro / np.linalg.norm(ro, axis=1, keepdims=True) * 4.0 + [0, 1, 0]
    target = rng.uniform(-1, 1, (512, 3)) * [1.5, 0.8, 1.5] + [0, 0.5, 0]
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro = jnp.asarray(ro, jnp.float32)
    rd = jnp.asarray(rd, jnp.float32)
    packed = default_scene_data.packed
    hk = jax.jit(kernel)(packed.tri_pos, ro, rd)
    hm = mt_intersect(packed.tri_pos, ro, rd)
    assert_same_hits(hm, hk, min_hits=250)
    # the traversal breaks shared-edge t ties by visit order: compare t only
    hb = bvh_intersect(packed.nodes, packed.tri_pos, ro, rd)
    np.testing.assert_array_equal(np.asarray(hk.hit), np.asarray(hb.hit))
    m = np.asarray(hk.hit)
    np.testing.assert_allclose(np.asarray(hk.t)[m], np.asarray(hb.t)[m],
                               rtol=2e-5, atol=1e-6)


def test_kernel_parked_rays_miss(default_scene_data):
    """Terminated rays are parked at ro = 1e30, rd = 0 by the trace loop:
    their determinant is exactly 0, so they miss with no inf/nan."""
    ro = jnp.full((40, 3), 1e30, jnp.float32)
    rd = jnp.zeros((40, 3), jnp.float32)
    h = kernel(default_scene_data.packed.tri_pos, ro, rd)
    assert not np.asarray(h.hit).any()
    assert np.all(np.asarray(h.tri) == -1)
    assert np.isfinite(np.asarray(h.t)).all()


def test_kernel_empty_scene():
    rng = np.random.default_rng(9)
    ro, rd = random_rays(rng, 20)
    h = kernel(jnp.zeros((0, 9), jnp.float32), ro, rd)
    assert h.t.shape == (20,)
    assert not np.asarray(h.hit).any()
    assert np.all(np.asarray(h.tri) == -1)


def test_kernel_padding_triangles_never_hit():
    """All-zero triangles (the scene's padding rows, and the kernel's own
    chunk padding) have a == 0: never a hit, whatever the ray."""
    rng = np.random.default_rng(4)
    ro, rd = random_rays(rng, 200, spread=0.5)
    h = kernel(jnp.zeros((70, 9), jnp.float32), ro, rd)
    assert not np.asarray(h.hit).any()
    # a real triangle behind 70 zero rows still wins its rays
    tri = jnp.concatenate(
        [jnp.zeros((70, 9), jnp.float32),
         jnp.asarray([[-1, -1, -2, 1, -1, -2, 0, 1, -2]], jnp.float32)])
    ro = jnp.zeros((8, 3), jnp.float32)
    rd = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32), (8, 1))
    h = kernel(tri, ro, rd)
    assert np.asarray(h.hit).all()
    assert np.all(np.asarray(h.tri) == 70)


@pytest.mark.parametrize("gap", [1, 40])
def test_kernel_lowest_index_tie_break(gap):
    """Identical triangles at indices 3 and 3 + gap: the lower index wins,
    within one chunk (gap 1) and across chunks (gap 40 > block_tris)."""
    tri1 = jnp.asarray([[-1, -1, -2, 1, -1, -2, 0, 1, -2]], jnp.float32)
    far = jnp.asarray([[-1, -1, -9, 1, -1, -9, 0, 1, -9]], jnp.float32)
    rows = [far] * (4 + gap)
    rows[3] = tri1
    rows[3 + gap] = tri1
    tri = jnp.concatenate(rows, axis=0)
    ro = jnp.zeros((4, 3), jnp.float32)
    rd = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32), (4, 1))
    h = kernel(tri, ro, rd, block_tris=32)
    assert np.asarray(h.hit).all()
    assert np.all(np.asarray(h.tri) == 3)
    np.testing.assert_allclose(np.asarray(h.t), 2.0, rtol=1e-6)


def test_coef_rows_are_the_nonzero_columns():
    """The kernel's compact (19, N) table holds exactly the non-zero rows of
    the (10, 4, N) matmul table, in phi order within each determinant."""
    rng = np.random.default_rng(2)
    tri = random_tri_pos(rng, 16)
    rows = np.asarray(triangle_coef_rows(tri))
    cols = np.asarray(triangle_columns(tri))
    expect = np.concatenate([
        cols[4:7, 0], cols[4:10, 1], cols[4:10, 2], cols[0:4, 3],
    ])
    np.testing.assert_array_equal(rows, expect)
    nonzero = np.count_nonzero(np.abs(cols).sum(axis=2))
    assert rows.shape == (19, 16) and nonzero == 19


# --- the kernel inside the trace loop --------------------------------------


def _trace(scene_data, env_importance, differentiable=False, n=64):
    rng = np.random.default_rng(5)
    cam = Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
    params = RenderParams.create(cam, frame=1)
    ro = jnp.tile(jnp.asarray([[0.0, 1.0, 4.0]], jnp.float32), (n, 1))
    target = rng.uniform(-1.2, 1.2, (n, 3)) * [1, 0.6, 1] + [0, 0.5, 0]
    rd = jnp.asarray(target, jnp.float32) - ro
    rd = rd / jnp.linalg.norm(rd, axis=1, keepdims=True)
    seed = jnp.arange(n, dtype=jnp.uint32) * jnp.uint32(2654435761)
    return trace.trace_rays(
        scene_data, params, ro, rd, seed, max_bounces=3,
        env_importance=env_importance, differentiable=differentiable,
        intersector="mt",
    )


@pytest.mark.parametrize("env_importance", [False, True])
def test_trace_rays_with_kernel_matches_mt(default_scene_data, monkeypatch,
                                           env_importance):
    """The whole bounce loop with the kernel in place of the XLA intersector
    (swapped in through trace.MT_FNS, a test-only seam): RNG streams
    bit-exact, radiance to float32 re-association."""
    ref_light, ref_seed = _trace(default_scene_data, env_importance)
    monkeypatch.setitem(trace.MT_FNS, "mt", kernel)
    light, seed = _trace(default_scene_data, env_importance)
    np.testing.assert_array_equal(np.asarray(seed), np.asarray(ref_seed))
    np.testing.assert_allclose(np.asarray(light), np.asarray(ref_light),
                               rtol=1e-5, atol=1e-6)
    assert np.asarray(ref_light).max() > 0


def test_differentiable_trace_gradients_match_mt(default_scene_data,
                                                 monkeypatch):
    """Path-replay gradients (detached kernel + analytic replay) w.r.t. the
    material colours and the vertex positions equal the XLA path's."""
    def loss(colors, tri_pos, scene=default_scene_data):
        import dataclasses

        packed = dataclasses.replace(scene.packed, tri_pos=tri_pos)
        s = dataclasses.replace(
            scene, packed=packed,
            materials=dataclasses.replace(scene.materials, color=colors))
        light, _ = _trace(s, False, differentiable=True, n=32)
        return jnp.sum(light ** 2)

    args = (default_scene_data.materials.color,
            default_scene_data.packed.tri_pos)
    ref = jax.grad(loss, argnums=(0, 1))(*args)
    monkeypatch.setitem(trace.MT_FNS, "mt", kernel)
    got = jax.grad(loss, argnums=(0, 1))(*args)
    for a, b in zip(got, ref):
        assert np.isfinite(np.asarray(a)).all()
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-6)
    assert np.abs(np.asarray(ref[0])).sum() > 0


# --- dispatch ---------------------------------------------------------------


@pytest.mark.parametrize(
    "backend,n_tris,expected",
    [
        ("gpu", 2048, "mt_pallas"),
        ("gpu", trace.MT_AUTO_MAX_TRIS, "mt_pallas"),
        ("gpu", trace.MT_AUTO_MAX_TRIS + 1, "bvh8"),
        ("cpu", 2048, "mt"),
        ("cpu", trace.MT_AUTO_MAX_TRIS + 1, "bvh8"),
        ("other", 2048, "mt"),  # any backend but the GPU
    ],
)
def test_resolve_auto_by_backend_and_size(backend, n_tris, expected):
    assert trace.resolve_intersector("auto", n_tris, backend) == expected


@pytest.mark.parametrize("name", ["mt", "bvh", "bvh8"])
def test_explicit_xla_intersectors_on_any_backend(name):
    for backend in ("cpu", "gpu"):
        assert trace.resolve_intersector(name, 64, backend) == name


@pytest.mark.parametrize("backend", ["cpu", "other"])
def test_explicit_kernel_off_gpu_raises(backend):
    with pytest.raises(ValueError, match="GPU kernel"):
        trace.resolve_intersector("mt_pallas", 64, backend)


def test_explicit_kernel_off_gpu_raises_through_render(default_scene_data):
    cam = Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
    with pytest.raises(ValueError, match="GPU kernel"):
        trace.render_frame(
            default_scene_data, RenderParams.create(cam, frame=1),
            width=4, height=4, aspect=1.0, intersector="mt_pallas")


def test_user_facing_intersector_names():
    from tpu_pathtracer.config import INTERSECTORS

    assert INTERSECTORS == ("auto", "mt", "mt_pallas", "bvh", "bvh8")
    with pytest.raises(ValueError, match="unknown"):
        trace.resolve_intersector("mt_stream", 64, "gpu")


# --- on the card ------------------------------------------------------------


@pytest.mark.gpu
def test_compiled_kernel_matches_mt(gpu, default_scene_data):
    rng = np.random.default_rng(1)
    ro, rd = random_rays(rng, 4099, spread=2.0)
    tri = default_scene_data.packed.tri_pos
    with jax.default_matmul_precision("highest"):
        ha = jax.jit(mt_intersect)(tri, ro, rd)
    hb = jax.jit(mt_intersect_triton)(tri, ro, rd)
    same = np.asarray(ha.tri) == np.asarray(hb.tri)
    assert same.mean() >= 0.9999
    assert_close_tuv(ha, hb, np.asarray(ha.hit) & same)


@pytest.mark.gpu
def test_compiled_render_auto_uses_kernel(gpu, default_scene_data):
    assert trace.resolve_intersector(
        "auto", default_scene_data.packed.tri_pos.shape[0]) == "mt_pallas"
    cam = Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
    kw = dict(width=64, height=64, aspect=1.0, max_bounces=3)
    params = RenderParams.create(cam, frame=1)
    a = jax.jit(partial(trace.render_frame, intersector="auto", **kw))(
        default_scene_data, params)
    b = jax.jit(partial(trace.render_frame, intersector="mt", **kw))(
        default_scene_data, params)
    diff = np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1)
    assert np.isfinite(np.asarray(a)).all()
    assert (diff > 1e-3).mean() < 0.01
