"""The honest benchmark harness (render/benchmark.py): smoke + gate logic.

These tests exercise the slope/linearity machinery itself on the CPU; the
physics gate is given the H100's published peaks, and the profiler
cross-check (which needs a device trace) is tested through its parts in
tests/test_measurement.py.
"""

import jax
import numpy as np
import pytest

import tpu_pathtracer as pt
from tpu_pathtracer.render.benchmark import (
    BenchResult,
    bench_config,
    device_info,
    headline_record,
    measure_budget,
)
from tpu_pathtracer.scene.envmap import gradient_sky
from tpu_pathtracer.scene.types import Camera


@pytest.fixture(scope="module")
def small_scene():
    scene = pt.default_scene(gradient_sky(8, 16))
    return jax.device_put(scene.compile())


def test_bench_config_smoke(small_scene):
    cam = Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
    res = bench_config(
        small_scene, cam, width=32, height=32, spp=1, bounces=2,
        reps=2, target_seconds=0.05,
    )
    assert res.rays_per_s > 0
    assert res.per_frame_s > 0
    assert res.n2 == 2 * res.n1
    device = device_info()
    rec = headline_record(res, device)
    assert rec["metric"] == "ray_scene_intersections_per_s_cpu"
    assert rec["value"] == res.rays_per_s
    assert rec["device"] == {"platform": "cpu", "kind": "cpu", "count": 8}
    assert "vs_baseline" not in rec
    assert res.busy_share is None and res.device_per_frame_s is None


def test_physics_gate_refuses_impossible(small_scene, monkeypatch):
    """A budget function that does ~no work must be refused: the implied
    throughput exceeds the device's published peaks (and usually the
    linearity gate fires too).  The CPU has no peaks, so the test gives
    the gate the H100's."""
    import jax.numpy as jnp

    from tpu_pathtracer.render import benchmark

    monkeypatch.setattr(
        benchmark, "device_peaks",
        lambda device=None: benchmark.PEAKS["NVIDIA H100 80GB HBM3"])

    def fake_budget(scene_d, params, n):
        return jnp.zeros((256, 256, 3), jnp.float32)

    # Claimed work so large (4096^2 x 256 spp x 10 bounces = 4.4e13 rays
    # per frame) that passing physics would need > 55 s/frame of wall time
    # from a function that only allocates a tiny buffer — impossible, so
    # either the linearity gate or the physics gate must fire regardless
    # of timing noise.
    cam = Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
    res = measure_budget(
        fake_budget, small_scene, cam, width=4096, height=4096, spp=256,
        bounces=10, reps=2, target_seconds=0.02, profile=False,
    )
    assert not res.ok
    assert any("exceeds hardware" in r for r in res.reasons)
    rec = headline_record(res, device_info())
    assert rec.get("suspect") is True


def test_linearity_of_real_budget(small_scene):
    """On CPU, doubling frames must ~double wall time (sanity of the
    methodology itself)."""
    cam = Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
    res = bench_config(
        small_scene, cam, width=64, height=64, spp=1, bounces=3,
        reps=2, target_seconds=0.4,
    )
    assert res.ok, res.reasons
    assert 0.6 < res.linearity < 1.4


def test_scaling_harness_virtual_mesh(small_scene):
    """The mesh-scaling table runs on the 8-virtual-device CPU mesh and
    emits well-formed rows (real-card scaling is the same call via
    `bench.py --full`)."""
    from tpu_pathtracer.render.benchmark import bench_scaling

    cam = Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
    rows = bench_scaling(small_scene, cam, width=32, height=32, spp=1,
                         bounces=2, tile_counts=(1, 4), reps=2,
                         target_seconds=0.05)
    assert [r["tiles"] for r in rows] == [1, 4]
    for r in rows:
        assert r["per_frame_s"] > 0
        assert 0 < r["efficiency"]  # virtual devices share cores: no bound
