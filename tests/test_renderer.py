"""Renderer orchestration tests: state machine, events, progress, resume
(reference contract: renderer.ts:42, 334-468)."""

import numpy as np

import tpu_pathtracer as pt
from tpu_pathtracer.scene.envmap import gradient_sky


def _make(frames=3, w=8, h=8, **kw):
    scene = pt.Scene()
    scene.set_environment(gradient_sky(8, 16))
    cam = pt.Camera.create()
    cfg = pt.RenderConfig(width=w, height=h, frames=frames, samples_per_frame=1, max_bounces=1)
    return pt.Renderer(scene, cam, cfg, pt.PostConfig(denoise=False), **kw)


def test_state_machine_and_events():
    r = _make(frames=3)
    events = []
    for name in ("reset", "start", "pause", "progress", "complete"):
        r.on(name, lambda *a, name=name: events.append(name))

    assert r.status == "idle"
    r.reset()
    assert r.status == "sampling"
    assert "reset" in events and "start" in events

    r.render()
    assert r.frame == 2
    assert "progress" in events
    assert np.isclose(r.progress, 2 / 4)  # frame/(frames+1), renderer.ts:334-336

    r.pause()
    assert r.status == "paused"
    f = r.frame
    r.render()  # paused: no-op
    assert r.frame == f

    r.start()
    r.render()
    r.render()
    assert r.status == "idle"
    assert "complete" in events
    assert r.samples == 3  # (frame-1)*spp


def test_render_all_and_display():
    r = _make(frames=4)
    acc = np.asarray(r.render_all())
    assert acc.shape == (8, 8, 3)
    assert acc.mean() > 0  # env-lit
    disp = np.asarray(r.display())
    assert disp.shape == (8, 8, 3)
    assert 0.0 <= disp.min() and disp.max() <= 1.0  # ACES clamps


def test_accumulation_is_mean_of_frames():
    r = _make(frames=4)
    r.reset()
    imgs = []
    import jax

    from tpu_pathtracer.ops.trace import render_frame

    c = r.config
    while r.status == "sampling" and r.frame <= c.frames:
        params = r._params()
        img = render_frame(
            r.scene_data, params, width=8, height=8, aspect=1.0,
            samples_per_frame=1, max_bounces=1,
        )
        imgs.append(np.asarray(img, np.float64))
        r.render()
    mean = np.mean(imgs, axis=0)
    assert np.allclose(np.asarray(r.accumulation), mean, atol=1e-5)


def test_reset_clears_history():
    r = _make(frames=2)
    r.render_all()
    acc1 = np.asarray(r.accumulation).copy()
    r.reset()
    assert np.allclose(np.asarray(r.accumulation), 0.0)
    r.render_all()
    assert np.allclose(np.asarray(r.accumulation), acc1, atol=1e-6)


def test_save_load_state(tmp_path):
    r = _make(frames=4)
    r.reset()
    r.render()
    r.render()
    path = str(tmp_path / "ckpt.npz")
    r.save_state(path)

    r2 = _make(frames=4)
    r2.load_state(path)
    assert r2.frame == r.frame
    assert np.allclose(np.asarray(r2.accumulation), np.asarray(r.accumulation))
    r.render_all()
    r2.render_all()
    assert np.allclose(np.asarray(r.accumulation), np.asarray(r2.accumulation))


def test_set_option_resets_and_rebuilds():
    r = _make(frames=2)
    r.render_all()
    r.set_option(frames=3, max_bounces=2)
    assert r.config.frames == 3 and r.config.max_bounces == 2
    assert r.frame == 1 and r.status == "sampling"
    r.set_option(denoise=False, tonemap=pt.Tonemap.REINHARD)
    assert r.post.tonemap == pt.Tonemap.REINHARD
    r.set_option(env_intensity=2.0)
    assert r.env_intensity == 2.0


def test_scaling_factor_resolution():
    r = _make(frames=2, w=16, h=8)
    r.set_option(scaling_factor=0.5)
    r.render_all()
    assert np.asarray(r.accumulation).shape == (4, 8, 3)
    disp = np.asarray(r.display())
    assert disp.shape == (8, 16, 3)


def test_screenshot_roundtrip(tmp_path):
    from tpu_pathtracer.io.image import read_png

    r = _make(frames=2)
    r.render_all()
    path = str(tmp_path / "shot.png")
    r.screenshot(path)
    img = read_png(path)
    assert img.shape == (8, 8, 3)
    ref = np.asarray(r.display())[::-1]
    assert np.abs(img.astype(np.float64) / 255.0 - ref).max() < 1 / 255.0 + 1e-3


def test_metrics_jsonl(tmp_path):
    """MetricsLogger mirrors the event bus as JSONL records (SURVEY §5)."""
    import json

    from tpu_pathtracer.render.metrics import MetricsLogger

    r = _make(frames=3)
    path = str(tmp_path / "m.jsonl")
    m = MetricsLogger(r, path=path)
    r.reset()
    r.render_all()
    m.close()
    records = [json.loads(l) for l in open(path)]
    events = [rec["event"] for rec in records]
    assert events.count("progress") == 3
    assert "reset" in events and "start" in events and "complete" in events
    prog = [rec for rec in records if rec["event"] == "progress"]
    assert prog[-1]["progress"] > prog[0]["progress"]
    assert "rays_per_s" in prog[-1]


def test_render_all_auto_checkpoint(tmp_path):
    r = _make(frames=4)
    ck = str(tmp_path / "ck.npz")
    r.reset()
    r.render_all(checkpoint_path=ck, checkpoint_every=2)
    import numpy as np

    data = np.load(ck)
    assert int(data["frame"]) == 5  # final save after completion


def test_checked_render_clean():
    """checkify instrumentation: the default render must pass float/index
    checks (SURVEY §5 sanitizers)."""
    from tpu_pathtracer.scene.types import Camera, RenderParams
    from tpu_pathtracer.utils.debug import checked_render_frame

    scene = pt.default_scene(gradient_sky(8, 16)).compile()
    cam = Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0))
    err, img = checked_render_frame(
        scene, RenderParams.create(cam, frame=1),
        width=8, height=8, aspect=1.0, samples_per_frame=1, max_bounces=2,
    )
    assert err.get() is None
    assert np.isfinite(np.asarray(img)).all()


def test_sharded_renderer_matches_single_device():
    """Renderer(shard=ShardConfig(tiles=8)) on the virtual mesh must produce
    the same progressive image as the single-device renderer."""
    r0 = _make(frames=3, w=16, h=16)
    r1 = _make(frames=3, w=16, h=16, shard=pt.ShardConfig(tiles=8))
    r0.reset(); r0.render_all()
    r1.reset(); r1.render_all()
    np.testing.assert_allclose(
        np.asarray(r1.accumulation), np.asarray(r0.accumulation), atol=1e-6)


def test_sharded_renderer_save_load(tmp_path):
    r = _make(frames=4, w=16, h=16, shard=pt.ShardConfig(tiles=4))
    r.reset(); r.render(); r.render()
    p = str(tmp_path / "s.npz")
    r.save_state(p)
    r2 = _make(frames=4, w=16, h=16, shard=pt.ShardConfig(tiles=4))
    r2.load_state(p)
    assert r2.frame == r.frame
    np.testing.assert_allclose(
        np.asarray(r2.accumulation), np.asarray(r.accumulation))
    r.render_all(); r2.render_all()
    np.testing.assert_allclose(
        np.asarray(r2.accumulation), np.asarray(r.accumulation), atol=1e-7)
