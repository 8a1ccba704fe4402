"""Golden-image snapshot regression tests.

Unlike test_trace_golden.py (which checks the tracer against an independent
numpy oracle), these pin the EXACT rendered output across code changes:
small deterministic renders are compared byte-for-byte (after 8-bit
quantization) against PNGs committed under tests/golden/.

Regenerate intentionally with:
    python -m pytest tests/test_golden_snapshots.py --regen-golden
"""

import math
import os

import numpy as np
import pytest

import tpu_pathtracer as pt
from tpu_pathtracer.io.image import read_png, to_uint8, write_png
from tpu_pathtracer.scene import primitives
from tpu_pathtracer.scene.envmap import gradient_sky
from tpu_pathtracer.scene.host import Material, Mesh, Scene, rotation_x, translation
from tpu_pathtracer.scene.types import Camera, RenderParams

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _scene():
    white = Material(color=(1, 1, 1), roughness=1.0, metalness=0.02)
    red = Material(color=(1, 0.05, 0.05), roughness=1.0, metalness=0.0)
    mirror = Material(color=(0.9, 0.9, 0.9), roughness=0.05, metalness=0.9)
    sc = Scene()
    p, n, i = primitives.plane(5, 5)
    sc.add(Mesh(p, n, i, white, transform=rotation_x(-math.pi / 2)))
    p, n, i = primitives.box(0.8, 0.8, 0.8)
    sc.add(Mesh(p, n, i, red, transform=translation(0, 0.4, 0.5)))
    p, n, i = primitives.sphere(0.5, 12, 8)
    sc.add(Mesh(p, n, i, mirror, transform=translation(0, 0.5, -0.6)))
    sc.set_environment(gradient_sky(32, 64))
    return sc


def golden_diff(name: str, img_u8: np.ndarray):
    """(max u8 difference, fraction of differing values, mean |difference|)
    against the committed golden PNG `name`."""
    path = os.path.join(GOLDEN_DIR, name)
    assert os.path.exists(path), (
        f"missing golden {name}; run with --regen-golden to create"
    )
    golden = read_png(path)[..., :3]
    diff = np.abs(img_u8.astype(int) - golden.astype(int))
    return int(diff.max()), float((diff > 0).mean()), float(diff.mean())


def _check(request, name: str, img_u8: np.ndarray):
    path = os.path.join(GOLDEN_DIR, name)
    if request.config.getoption("--regen-golden", default=False):
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        write_png(path, img_u8)
        pytest.skip(f"regenerated {name}")
    # byte-exact after quantization, with a 1-step slack for cross-platform
    # f32 transcendental drift
    max_diff, frac, _ = golden_diff(name, img_u8)
    assert max_diff <= 1, f"{name}: max u8 diff {max_diff}"
    assert frac < 0.01, f"{name}: {100 * frac:.2f}% pixels differ"


def _render(frames=8, spp=1, bounces=3, post=None, size=48, cam=None,
            scaling_factor=1.0):
    cfg = pt.RenderConfig(width=size, height=size, frames=frames,
                          samples_per_frame=spp, max_bounces=bounces,
                          scaling_factor=scaling_factor)
    cam = cam or pt.Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0),
                                  fov=45)
    r = pt.Renderer(_scene(), cam, cfg,
                    post or pt.PostConfig(denoise=False))
    r.reset()
    r.render_all()
    return to_uint8(np.asarray(r.display())[::-1])


def render_dof():
    cam = pt.Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45,
                           focal_distance=3.5, aperture=0.25)
    return _render(bounces=2, cam=cam)


def render_halfscale_denoised():
    return _render(frames=6, scaling_factor=0.5, post=pt.PostConfig(denoise=True))


# golden PNG -> the render it pins (chip_smoke.py renders these on the card)
RENDERS = {
    "base_48.png": _render,
    "denoise_reinhard_48.png": lambda: _render(post=pt.PostConfig(
        denoise=True, tonemap=pt.Tonemap.REINHARD)),
    "dof_48.png": render_dof,
    "halfscale_denoise_48.png": render_halfscale_denoised,
}


def test_snapshot_base(request):
    _check(request, "base_48.png", RENDERS["base_48.png"]())


def test_snapshot_denoised_reinhard(request):
    _check(request, "denoise_reinhard_48.png",
           RENDERS["denoise_reinhard_48.png"]())


def test_snapshot_dof(request):
    _check(request, "dof_48.png", RENDERS["dof_48.png"]())


def test_snapshot_halfscale_denoised(request):
    """Resolution scaling path: render at 0.5 scale, upscale THEN denoise at
    display resolution (the reference's fullscreen-pass order,
    fullscreen.wgsl:47,117-119)."""
    img = RENDERS["halfscale_denoise_48.png"]()
    assert img.shape == (48, 48, 3)
    _check(request, "halfscale_denoise_48.png", img)
