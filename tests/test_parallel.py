"""Multi-device sharding tests on the 8-virtual-CPU-device mesh (SURVEY.md §4).

Contract under test (parallel/sharded.py):
  * row-tile sharding is BIT-IDENTICAL to the unsharded render,
  * sample-axis sharding psums to a valid same-budget Monte-Carlo estimate,
  * accumulation stays sharded across frames and matches the single-device
    progressive result.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_pathtracer.ops.trace import accumulate, render_frame
from tpu_pathtracer.parallel import (
    make_mesh,
    make_sharded_frame_step,
    zeros_acc,
)
from tpu_pathtracer.scene import primitives
from tpu_pathtracer.scene.envmap import gradient_sky
from tpu_pathtracer.scene.host import Material, Mesh, Scene, rotation_x, translation
from tpu_pathtracer.scene.types import Camera, RenderParams

W = H = 16
ASPECT = 1.0


def make_scene_data():
    white = Material(color=(1, 1, 1), roughness=1.0, metalness=0.0)
    sc = Scene()
    p, n, i = primitives.plane(4, 4)
    sc.add(Mesh(p, n, i, white, transform=rotation_x(-math.pi / 2)))
    p, n, i = primitives.box(0.8, 0.8, 0.8)
    sc.add(Mesh(p, n, i, white, transform=translation(0, 0.4, 0)))
    sc.set_environment(gradient_sky(16, 32))
    return sc.compile()


@pytest.fixture(scope="module")
def scene_data():
    return make_scene_data()


def _params(frame=1):
    cam = Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
    return RenderParams.create(cam, frame=frame)


def _unsharded(scene_data, frame=1, spp=1):
    return np.asarray(
        render_frame(
            scene_data, _params(frame), width=W, height=H, aspect=ASPECT,
            samples_per_frame=spp, max_bounces=2,
        )
    )


def test_tile_sharding_matches_unsharded(scene_data):
    # Same RNG streams and global pixel coordinates; only XLA fusion-order
    # ulps may differ between the sharded and unsharded compiled programs.
    mesh = make_mesh(tiles=8, samples=1)
    step = make_sharded_frame_step(
        mesh, width=W, height=H, aspect=ASPECT, samples_per_frame=1, max_bounces=2
    )
    acc = step(scene_data, _params(1), zeros_acc(mesh, H, W))
    ref = _unsharded(scene_data, frame=1, spp=1)
    np.testing.assert_allclose(np.asarray(acc), ref, atol=1e-6, rtol=0)


def test_tile_and_sample_sharding(scene_data):
    mesh = make_mesh(tiles=4, samples=2)
    step = make_sharded_frame_step(
        mesh, width=W, height=H, aspect=ASPECT, samples_per_frame=4, max_bounces=2
    )
    acc = np.asarray(step(scene_data, _params(1), zeros_acc(mesh, H, W)))
    ref = _unsharded(scene_data, frame=1, spp=4)
    # Decorrelated sample streams: not bit-identical, but an unbiased
    # same-budget estimate — bounded mean deviation on a mostly-smooth image.
    assert acc.shape == ref.shape
    assert np.isfinite(acc).all()
    assert abs(acc.mean() - ref.mean()) < 0.15
    assert np.abs(acc - ref).mean() < 0.35


def test_progressive_accumulation_matches_single_device(scene_data):
    mesh = make_mesh(tiles=8, samples=1)
    step = make_sharded_frame_step(
        mesh, width=W, height=H, aspect=ASPECT, samples_per_frame=1, max_bounces=2
    )
    acc = zeros_acc(mesh, H, W)
    ref_acc = jnp.zeros((H, W, 3), jnp.float32)
    for f in range(1, 4):
        acc = step(scene_data, _params(f), acc)
        ref_acc = accumulate(ref_acc, _unsharded(scene_data, frame=f), f, enabled=True)
    np.testing.assert_allclose(np.asarray(acc), np.asarray(ref_acc), atol=1e-6)


def test_sample_axis_psum_mean_semantics(scene_data):
    # samples=8, spp=8: every shard renders 1 sample; the psum-mean must be
    # finite and close to the 8-spp sequential render in expectation.
    mesh = make_mesh(tiles=1, samples=8)
    step = make_sharded_frame_step(
        mesh, width=W, height=H, aspect=ASPECT, samples_per_frame=8, max_bounces=2
    )
    acc = np.asarray(step(scene_data, _params(1), zeros_acc(mesh, H, W)))
    ref = _unsharded(scene_data, frame=1, spp=8)
    assert np.isfinite(acc).all()
    assert abs(acc.mean() - ref.mean()) < 0.1


def test_mesh_validation():
    with pytest.raises(ValueError):
        make_mesh(tiles=5, samples=3)  # 15 > 8 devices
    mesh = make_mesh(tiles=8, samples=1)
    with pytest.raises(ValueError):
        make_sharded_frame_step(mesh, width=W, height=12, aspect=1.0)  # 12 % 8 != 0


def test_sharded_grads_match_unsharded(scene_data):
    """DP gradient psum over tiles must equal the single-device gradient."""
    import jax

    from tpu_pathtracer import diff
    from tpu_pathtracer.parallel.diffshard import (
        make_sharded_value_and_grad,
        target_sharding,
    )

    kw = dict(width=W, height=H, aspect=ASPECT, samples_per_frame=1, max_bounces=2)
    params = _params(1)
    target = diff.render_frame_diff(scene_data, params, **kw) * 0.7
    paths = ["materials.color", "env.radiance"]

    loss = diff.make_loss(target, **kw)
    loss_p = diff.make_param_loss(loss, scene_data, params, paths)
    values = diff.extract(scene_data, params, paths)
    l_ref, g_ref = jax.value_and_grad(loss_p)(values)

    mesh = make_mesh(tiles=8, samples=1)
    vg = make_sharded_value_and_grad(mesh, scene_data, params, **kw)
    tgt_sharded = jax.device_put(target, target_sharding(mesh))
    l_sh, g_sh = vg(values, tgt_sharded)

    np.testing.assert_allclose(float(l_sh), float(l_ref), rtol=1e-5)
    for p in paths:
        np.testing.assert_allclose(
            np.asarray(g_sh[p]), np.asarray(g_ref[p]), atol=1e-6, rtol=1e-4,
            err_msg=p,
        )


def test_invert_sharded_converges(scene_data):
    import dataclasses

    import jax.numpy as jnp

    from tpu_pathtracer import diff
    from tpu_pathtracer.parallel.diffshard import invert_sharded

    kw = dict(width=W, height=H, aspect=ASPECT, samples_per_frame=1, max_bounces=2)
    params = _params(1)
    target = diff.render_frame_diff(scene_data, params, **kw)
    # the fixture dedups both meshes to ONE material -> perturb index 0
    wrong = scene_data.materials.color.at[0].set(jnp.array([0.1, 0.8, 0.3]))
    bad = dataclasses.replace(
        scene_data,
        materials=dataclasses.replace(scene_data.materials, color=wrong),
    )
    mesh = make_mesh(tiles=4, samples=1)
    res = invert_sharded(mesh, bad, params, target, ["materials.color"],
                         steps=80, learning_rate=8e-2, **kw)
    # the single shared material drives the whole scene: require a decisive
    # (>70%) loss drop rather than near-zero
    assert res.losses[-1] < res.losses[0] * 0.3, (res.losses[0], res.losses[-1])


def test_multihost_helpers_single_process(scene_data):
    """host_local_target/fetch_rows on the virtual mesh (single-process path
    of the multi-host helpers)."""
    import jax

    from tpu_pathtracer.parallel import acc_sharding
    from tpu_pathtracer.parallel.multihost import (
        fetch_rows,
        host_local_target,
        is_multihost,
    )

    assert not is_multihost()
    mesh = make_mesh(tiles=8, samples=1)
    data = np.arange(H * W * 3, dtype=np.float32).reshape(H, W, 3)
    arr = host_local_target(mesh, data, acc_sharding(mesh))
    assert arr.shape == (H, W, 3)
    present, got = fetch_rows(arr)
    assert present.all()  # single process owns every row
    np.testing.assert_array_equal(got, data)


def test_sharded_render_all_matches_stepwise(scene_data):
    """The whole-budget fori_loop path must equal frame-by-frame stepping."""
    from tpu_pathtracer.parallel import make_sharded_render_all

    mesh = make_mesh(tiles=4, samples=1)
    frames = 3
    render_all = make_sharded_render_all(
        mesh, width=W, height=H, aspect=ASPECT, frames=frames,
        samples_per_frame=1, max_bounces=2,
    )
    acc_all = np.asarray(render_all(scene_data, _params(1)))

    step = make_sharded_frame_step(
        mesh, width=W, height=H, aspect=ASPECT, samples_per_frame=1,
        max_bounces=2,
    )
    acc = zeros_acc(mesh, H, W)
    for f in range(1, frames + 1):
        acc = step(scene_data, _params(f), acc)
    np.testing.assert_allclose(acc_all, np.asarray(acc), atol=1e-6)


def test_two_process_distributed_render(tmp_path):
    """REAL multi-process evidence: two OS processes
    rendezvous through jax.distributed (gloo CPU collectives), each drives
    4 of the 8 global devices of the ('tiles','samples') mesh, and their
    combined row bands are BIT-IDENTICAL to the single-process sharded
    render of the same scene."""
    import socket
    import subprocess
    import sys as _sys

    child = os.path.join(os.path.dirname(__file__), "multihost_child.py")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # child configures its own device count
    outs = [str(tmp_path / f"out{i}.npz") for i in range(2)]
    procs = [
        subprocess.Popen(
            [_sys.executable, child, str(i), "2", str(port), outs[i]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append((p.returncode, stdout, stderr))
    for rc, stdout, stderr in logs:
        assert rc == 0, f"child failed rc={rc}\nstdout:{stdout}\nstderr:{stderr[-2000:]}"

    a0, a1 = np.load(outs[0]), np.load(outs[1])
    assert not (a0["present"] & a1["present"]).any(), "row ownership overlaps"
    assert (a0["present"] | a1["present"]).all(), "rows missing"
    combined = a0["data"] + a1["data"]

    # single-process reference on this test process's own 8-device mesh
    import tpu_pathtracer as pt
    from tpu_pathtracer.parallel import sharded
    from tpu_pathtracer.scene.envmap import gradient_sky
    from tpu_pathtracer.scene.types import Camera, RenderParams

    mesh = make_mesh(tiles=8, samples=1)
    scene = jax.device_put(pt.default_scene(gradient_sky(16, 32)).compile())
    cam = Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
    params = RenderParams.create(cam, frame=1)
    step = sharded.make_sharded_frame_step(mesh, width=16, height=16, aspect=1.0)
    ref = np.asarray(step(scene, params, sharded.zeros_acc(mesh, 16, 16)))
    np.testing.assert_array_equal(combined, ref)


def test_sample_shard_estimator_converges_to_sequential(scene_data):
    """Convergence check: accumulating many frames,
    the sample-sharded estimator must converge to the SEQUENTIAL estimator's
    converged image — a subtle bias in the decorrelated sample streams would
    leave a persistent gap that no frame count shrinks."""
    mesh = make_mesh(tiles=1, samples=4)
    step = make_sharded_frame_step(
        mesh, width=W, height=H, aspect=ASPECT, samples_per_frame=4,
        max_bounces=2,
    )

    def sharded_mean(frames):
        acc = zeros_acc(mesh, H, W)
        for f in range(1, frames + 1):
            acc = step(scene_data, _params(f), acc)
        return np.asarray(acc, np.float64)

    def sequential_mean(frames):
        ref = jnp.zeros((H, W, 3), jnp.float32)
        for f in range(1, frames + 1):
            ref = accumulate(ref, _unsharded(scene_data, frame=f, spp=4), f,
                             enabled=True)
        return np.asarray(ref, np.float64)

    truth = sequential_mean(96)
    errs = [np.abs(sharded_mean(n) - truth).mean() for n in (6, 48)]
    # 8x the frames must cut the gap roughly like 1/sqrt(N) (allow slack for
    # the truth's own residual noise); an estimator bias would plateau.
    assert errs[1] < errs[0] * 0.55, errs
    assert errs[1] < 0.15, errs


def test_sharded_render_all_one_program_all_counts(scene_data):
    """render_all's frame count is a traced fori_loop bound: different
    counts must reuse ONE compiled program."""
    from tpu_pathtracer.parallel import make_sharded_render_all

    mesh = make_mesh(tiles=2, samples=1)
    render_all = make_sharded_render_all(
        mesh, width=W, height=H, aspect=ASPECT, samples_per_frame=1,
        max_bounces=2,
    )
    a1 = np.asarray(render_all(scene_data, _params(1), 1))
    a3 = np.asarray(render_all(scene_data, _params(1), 3))
    assert np.isfinite(a1).all() and np.isfinite(a3).all()
    # the two counts ran through the same jitted callable with one trace
    import jax

    inner = [c for c in (getattr(render_all, "__closure__", None) or ())
             if hasattr(c.cell_contents, "_cache_size")]
    if inner:
        assert inner[0].cell_contents._cache_size() == 1
    # count-3 equals stepwise accumulation
    step = make_sharded_frame_step(
        mesh, width=W, height=H, aspect=ASPECT, samples_per_frame=1,
        max_bounces=2,
    )
    acc = zeros_acc(mesh, H, W)
    for f in range(1, 4):
        acc = step(scene_data, _params(f), acc)
    np.testing.assert_allclose(a3, np.asarray(acc), atol=1e-6)
