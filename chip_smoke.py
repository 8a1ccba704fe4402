"""End-to-end smoke test of the renderer on NVIDIA GPUs.

    python chip_smoke.py            # one card: phases 0-7
    python chip_smoke.py --multi    # four cards: the sharded path only

Every phase runs in this one process, which owns the card(s).  A failed
check raises, so the script exits non-zero and never reaches its last line:
one JSON object naming the device, printed only when every phase passed.

Phases on one card:
  0. JAX's device is a GPU (there is no CPU fallback); the card's name and
     power limit from nvidia-smi, the JAX version, the compile cache.
  1. The fused MT kernel (ops/pallas/mt_triton.py) against the XLA
     intersector (ops/mt_matmul.py) at real widths, the numpy oracle at the
     golden-test size, and the `gpu`-marked tests.
  2. The golden snapshot renders (tests/test_golden_snapshots.py).
  3. Kernel against XLA end to end: headline and envlit frames.
  4. The post pass's share of the envlit frame.
  5. The ~100K-triangle stress scene (bvh8) by ray sub-batch; kernel
     against bvh8 at the MT_AUTO_MAX_TRIS boundary.
  6. A few inverse-rendering steps.
  7. bench.py's headline record.
With --multi (four cards): a 1080p tile-sharded frame against the
single-card frame, the sample-sharded estimator against the sequential
one, and sharded gradients against single-card gradients.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

# Parity tolerance of the kernel against the XLA intersector (see PERF.md):
# both sides are float32 and differ only in FMA contraction and summation
# order, so (t, u, v) agree to 1e-5 relative (1e-5 absolute below 1) or,
# where the determinants cancel badly, to the float32 rounding bound of
# their sums (`_rounding_bound`).  The triangle choice may differ only on
# exact ties and on grazing rays, whose accepted hit sits within that
# bound of a validity threshold (mostly a bounce ray re-hitting its own
# surface at t ~ EPSILON); at least MIN_SAME_TRI of all rays agree.
TUV_TOL = 1e-5
MIN_SAME_TRI = 0.999
GAMMA = 16 * 2.0**-24  # rounding of a ~10-term float32 sum, in units of it

# Cells: scene, width, height, bounces (1 spp each).  The scenes are
# bench.py's: the default scene pads to 2,048 triangles; mesh_scene(s) is a
# UV sphere of s segments over a plane.
CELLS = {
    "headline": ("default", 512, 512, 4),
    "envlit": ("mesh1K", 1920, 1080, 4),
    "stress": ("stress100K", 512, 512, 6),
    "mesh8K": ("mesh8K", 512, 512, 4),
}
SPHERE_SEGMENTS = {"mesh1K": 32, "mesh8K": 90, "stress100K": 320}
PADDED_TRIS = {"default": 2048, "mesh8K": 8192}
MULTI_FRAME = (1920, 1080)  # --multi: width, height of the sharded frame


def say(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


class Phase:
    def __init__(self, title):
        self.title = title

    def __enter__(self):
        say(f"== {self.title}")
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            say(f"   ({time.perf_counter() - self.t0:.1f} s)")


# ------------------------------------------------------------ helpers


def scenes():
    import tpu_pathtracer as pt
    from bench import mesh_scene
    from tpu_pathtracer.scene.envmap import gradient_sky

    sky = gradient_sky(512, 1024)
    out = {name: mesh_scene(seg, sky) for name, seg in SPHERE_SEGMENTS.items()}
    out["default"] = pt.default_scene(gradient_sky(64, 128))
    return out


def headline_camera():
    from tpu_pathtracer.scene.types import Camera

    return Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)


def rays_at_bounce(scene_data, cam, width, height, bounce):
    """The trace loop's rays entering `bounce` (1 = primary) of frame 1:
    jittered camera rays advanced by the XLA intersector and the shading
    step, terminated rays parked as ops/trace.trace_rays parks them."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_pathtracer.ops import camera as camera_ops
    from tpu_pathtracer.ops import envsample, rng, trace
    from tpu_pathtracer.ops.mt_matmul import mt_intersect
    from tpu_pathtracer.scene.types import RenderParams

    params = RenderParams.create(cam, frame=1)
    R = width * height

    def park(carry):
        am = carry[5][:, None]
        return (jnp.where(am, carry[0], jnp.float32(1e30)),
                jnp.where(am, carry[1], jnp.float32(0.0)))

    @jax.jit
    def f(scene):
        xs = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1)
        ys = jax.lax.broadcasted_iota(jnp.int32, (height, width), 0)
        uv = jnp.stack([xs / np.float32(width), ys / np.float32(height)],
                       axis=-1).reshape(R, 2).astype(jnp.float32)
        seed = rng.pixel_seed((xs + ys * width).reshape(R), params.frame)
        o, d = camera_ops.camera_rays(params.camera, uv,
                                      jnp.float32(width / height))
        seed, o, d = camera_ops.apply_dof(
            seed, o, d, params.camera,
            jnp.array([width, height], jnp.float32))
        carry = (o, d, jnp.zeros((R, 3)), jnp.ones((R, 3)), seed,
                 jnp.ones((R,), bool))
        shade_mat = trace.pack_shade_material_rows(scene)
        env_patches = envsample.pack_env_patches(scene.env.radiance)
        for _ in range(bounce - 1):
            hit = mt_intersect(scene.packed.tri_pos, *park(carry))
            carry = trace.bounce_shade(scene, params, hit, carry,
                                       shade_mat=shade_mat,
                                       env_patches=env_patches)
        return park(carry)

    return f(scene_data)


def _rounding_bound(tri_pos, ro, rd, tri, t, u, v):
    """Forward float32 rounding bound of (t, u, v) = (t*a, u*a, v*a) / a
    for each lane: GAMMA times the magnitudes of every product that goes
    into the determinants and into their coefficients (e1 = p1 - p0, the
    cross products), over |a|."""
    import numpy as np

    def xabs(x, y):  # componentwise bound of |x cross y|
        return np.stack([x[:, 1] * y[:, 2] + x[:, 2] * y[:, 1],
                         x[:, 2] * y[:, 0] + x[:, 0] * y[:, 2],
                         x[:, 0] * y[:, 1] + x[:, 1] * y[:, 0]], axis=1)

    tp = np.asarray(tri_pos, np.float64)[tri]  # (L, 9)
    rd = np.asarray(rd, np.float64)
    a = np.abs((rd * np.cross(tp[:, 6:9] - tp[:, 0:3],
                              tp[:, 3:6] - tp[:, 0:3])).sum(1))
    p0, p1, p2 = np.abs(tp[:, 0:3]), np.abs(tp[:, 3:6]), np.abs(tp[:, 6:9])
    e1, e2 = p1 + p0, p2 + p0  # |p1 - p0| <= |p1| + |p0|
    ro, rd = np.abs(np.asarray(ro, np.float64)), np.abs(rd)
    rxd = xabs(ro, rd)
    s_a = (rd * xabs(e2, e1)).sum(1)
    s_u = (rd * xabs(e2, p0)).sum(1) + (rxd * e2).sum(1)
    s_v = (rd * xabs(p0, e1)).sum(1) + (rxd * e1).sum(1)
    s_t = (e2 * xabs(p0, e1)).sum(1) + (ro * xabs(e1, e2)).sum(1)
    a = np.maximum(a, 1e-30)
    return {f: GAMMA * (s + np.abs(x) * s_a) / a
            for f, s, x in (("t", s_t, t), ("u", s_u, u), ("v", s_v, v))}


def compare_hits(label, tri_pos, ro, rd):
    """Kernel vs XLA intersector on one ray set; prints the statistics and
    checks the tolerance."""
    import jax
    import numpy as np

    from tpu_pathtracer.ops.mt_matmul import mt_intersect
    from tpu_pathtracer.ops.pallas.mt_triton import mt_intersect_triton
    from tpu_pathtracer.ops.vecmath import EPSILON

    ha = jax.device_get(jax.jit(mt_intersect)(tri_pos, ro, rd))
    hb = jax.device_get(jax.jit(mt_intersect_triton)(tri_pos, ro, rd))
    live = np.asarray(rd).any(axis=1)
    same = ha.tri == hb.tri
    differ = ~same
    tie = (differ & ha.hit & hb.hit
           & (np.abs(ha.t - hb.t) <= TUV_TOL * np.maximum(np.abs(ha.t), 1.0)))
    grazing = differ & ~tie
    for h in (ha, hb):
        # the nearer side's hit decides; it must sit at a threshold
        near = grazing & h.hit & (h.t <= np.minimum(ha.t, hb.t))
        i = np.flatnonzero(near)
        bound = _rounding_bound(tri_pos, np.asarray(ro)[i],
                                np.asarray(rd)[i], h.tri[i], h.t[i],
                                h.u[i], h.v[i])
        margin = np.minimum.reduce([
            (h.t[i] - EPSILON) / (bound["t"] + 1e-30),
            h.u[i] / (bound["u"] + 1e-30), h.v[i] / (bound["v"] + 1e-30),
            (1.0 - h.u[i] - h.v[i]) / (bound["u"] + bound["v"] + 1e-30)])
        grazing[i[margin > 1.0]] = False
    agree = same & ha.hit
    errs = {}
    for f in ("t", "u", "v"):
        a, b = getattr(ha, f)[agree], getattr(hb, f)[agree]
        errs[f] = np.abs(a - b) / np.maximum(np.abs(a), 1.0)
    over = np.zeros(int(agree.sum()), bool)
    for e in errs.values():
        over |= e > TUV_TOL
    idx = np.flatnonzero(agree)[over]
    bound = _rounding_bound(tri_pos, np.asarray(ro)[idx], np.asarray(rd)[idx],
                            ha.tri[idx], ha.t[idx], ha.u[idx], ha.v[idx])
    unexplained = 0
    for f in ("t", "u", "v"):
        d = np.abs(getattr(ha, f)[idx] - getattr(hb, f)[idx])
        unexplained += int(((errs[f][over] > TUV_TOL) & (d > bound[f])).sum())
    say(f"   {label}: {ro.shape[0]} rays ({live.sum()} live), "
        f"{int(ha.hit.sum())} hits; triangle identical on "
        f"{same.mean() * 100:.4f}%; {int(differ.sum())} differ "
        f"({int(tie.sum())} exact ties, {int(grazing.sum())} grazing, "
        f"{int((differ & ~tie & ~grazing).sum())} other); max rel err on "
        "agreeing hits "
        + ", ".join(f"{f} {e.max() if e.size else 0.0:.2e}"
                    for f, e in errs.items())
        + f"; {int(over.sum())} lane(s) over {TUV_TOL:g}, {unexplained} "
        "beyond the float32 rounding bound")
    check(same.mean() >= MIN_SAME_TRI, f"{label}: triangle choice differs")
    check(not (differ & ~tie & ~grazing).any(),
          f"{label}: triangle choice differs beyond ties and grazing rays")
    check(unexplained == 0, f"{label}: (t, u, v) beyond tolerance")


def run_pytest(*args):
    import pytest

    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                      *args])
    check(rc == 0, f"pytest {args} exited {rc}")


def bench(label, data, cam, width, height, spp, bounces, intersector,
          post=None, memory=False):
    """bench_config on the card; optionally first prints the compiled
    step's memory analysis and skips a program that cannot fit."""
    import jax

    from tpu_pathtracer.render.benchmark import bench_config, make_budget
    from tpu_pathtracer.scene.types import RenderParams

    if memory:
        budget = make_budget(width, height, spp, bounces, width / height,
                             intersector, post=post)
        ma = budget.lower(data, RenderParams.create(cam, frame=1), 1) \
            .compile().memory_analysis()
        need = ma.temp_size_in_bytes + ma.argument_size_in_bytes \
            + ma.output_size_in_bytes
        limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit")
        say(f"   {label}: memory_analysis temp "
            f"{ma.temp_size_in_bytes / 1e9:.3f} GB, arguments "
            f"{ma.argument_size_in_bytes / 1e9:.3f} GB, output "
            f"{ma.output_size_in_bytes / 1e9:.3f} GB (device limit "
            f"{limit and limit / 1e9} GB)")
        if limit and need > limit:
            say(f"   {label}: does not fit on the card, not timed")
            return None
    res = bench_config(data, cam, width=width, height=height, spp=spp,
                       bounces=bounces, aspect=width / height, reps=3,
                       target_seconds=0.5, intersector=intersector,
                       post=post)
    say(f"   {label}: {res.per_frame_s * 1e3:.3f} ms/frame, "
        f"{res.rays_per_s:.4e} rays/s, "
        f"{width * height * spp / res.per_frame_s:.4e} paths/s, device busy "
        f"{(res.device_per_frame_s or 0) * 1e3:.3f} ms/frame, busy share "
        f"{res.busy_share}, compile {res.compile_s:.1f} s, linearity "
        f"{res.linearity:.3f}, ok={res.ok} {res.reasons}")
    check(res.ok, f"{label}: measurement refused: {res.reasons}")
    return res


# ------------------------------------------------------------ phases


def phase0():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX's device is {dev.platform!r}, not a GPU; "
              "there is no CPU fallback", file=sys.stderr)
        sys.exit(2)
    from tpu_pathtracer.render.benchmark import card_name_and_power_limit
    from tpu_pathtracer.utils.compcache import enable_compilation_cache

    card = card_name_and_power_limit()
    check(card, "nvidia-smi reported no card")
    say(card)
    say(f"jax {jax.__version__}; device_kind {dev.device_kind!r}; "
        f"{len(jax.devices())} device(s); compile cache "
        f"{enable_compilation_cache()}")


def phase1(sc):
    import jax
    import test_trace_golden as tg

    cam = headline_camera()
    _, w, h, _ = CELLS["headline"]
    for name, padded in PADDED_TRIS.items():
        data = jax.device_put(sc[name].compile())
        n = data.packed.tri_pos.shape[0]
        check(n == padded, f"{name} pads to {n} triangles, not {padded}")
        for bounce in (1, 2):
            ro, rd = rays_at_bounce(data, cam, w, h, bounce)
            compare_hits(f"{name} ({n} tris) {w}x{h} bounce {bounce}",
                         data.packed.tri_pos, ro, rd)
    # the numpy oracle at tests/test_trace_golden.py's size, rendered with
    # the default ('auto' = kernel) path
    mini = tg._mini_scene()
    tg._assert_images_close(tg._render_jax(mini, 32, 32, frame=1),
                            tg._render_oracle(mini, 32, 32, frame=1))
    say("   oracle (32^2, frame 1): within test_trace_golden's tolerance")
    run_pytest("-m", "gpu", os.path.join(ROOT, "tests", "test_mt_triton.py"))


def phase2():
    """The goldens were rendered on the CPU.  The test's bound (<= 1 step on
    < 1% of values) holds only where float32 arithmetic matches the CPU's
    bit for bit; on the card a reordered sum can flip one hit or specular
    decision, which changes that sample's whole path, and the denoiser
    spreads the change over its radius (PERF.md).  So the card bound is a
    mean |difference| below one 8-bit step.  The XLA intersector's drift
    on the same card is printed first, as the platform's own share."""
    import test_golden_snapshots as gs

    from tpu_pathtracer.ops import trace
    from tpu_pathtracer.ops.mt_matmul import mt_intersect

    kernel = trace.MT_FNS["mt_pallas"]
    for variant in ("XLA mt", "kernel"):
        trace.MT_FNS["mt_pallas"] = (mt_intersect if variant == "XLA mt"
                                     else kernel)
        for name, render in gs.RENDERS.items():
            max_diff, frac, mean = gs.golden_diff(name, render())
            strict = max_diff <= 1 and frac < 0.01
            say(f"   [{variant}] {name}: max u8 diff {max_diff}, "
                f"{frac * 100:.3f}% of values differ, mean |diff| "
                f"{mean:.4f} -> {'test bound' if strict else 'card bound'}")
            check(mean < 1.0, f"[{variant}] {name}: outside the card bound")
    trace.MT_FNS["mt_pallas"] = kernel


def phase3(sc):
    import jax

    from tpu_pathtracer.config import PostConfig

    cam = headline_camera()
    out = {}
    for cell, post in (("headline", None),
                       ("envlit", PostConfig(denoise=True))):
        name, w, h, b = CELLS[cell]
        data = jax.device_put(sc[name].compile())
        for isect in ("mt", "mt_pallas"):
            out[cell, isect] = bench(
                f"{cell} {w}x{h}x1x{b}{' +denoise+ACES' if post else ''} "
                f"[{isect}]", data, cam, w, h, 1, b, isect, post=post,
                memory=True)
        mt, kern = out[cell, "mt"], out[cell, "mt_pallas"]
        if mt is not None:
            say(f"   {cell}: XLA mt / kernel = "
                f"{mt.per_frame_s / kern.per_frame_s:.3f}")
    return out


def phase4(sc, envlit_kernel):
    import jax
    import jax.numpy as jnp

    from tpu_pathtracer.config import PostConfig
    from tpu_pathtracer.post.denoise import smart_denoise
    from tpu_pathtracer.render.benchmark import device_peaks
    from tpu_pathtracer.utils.devtime import device_time

    name, w, h, b = CELLS["envlit"]
    data = jax.device_put(sc[name].compile())
    plain = bench("envlit, ACES only [mt_pallas]", data, headline_camera(),
                  w, h, 1, b, "mt_pallas", post=PostConfig(denoise=False))
    share = 1.0 - plain.per_frame_s / envlit_kernel.per_frame_s
    say(f"   denoise share of the envlit frame: {share:.4f}")
    img = jax.random.uniform(jax.random.PRNGKey(0), (h, w, 3))
    f = jax.jit(smart_denoise)
    jax.block_until_ready(f(img))
    reps = 20
    dt = device_time(lambda: [f(img) for _ in range(reps)])
    check(dt["ok"], "no device ops in the denoise trace")
    per = dt["busy_s"] / reps
    min_bytes = 2 * img.size * 4  # read the image once, write it once
    bw = device_peaks()["hbm_bps"]
    say(f"   jnp denoise {w}x{h}: {per * 1e6:.1f} us/call device busy in "
        f"{len(dt['ops'])} distinct device op(s); minimum traffic "
        f"{min_bytes / 1e6:.1f} MB -> {min_bytes / per / 1e9:.1f} GB/s = "
        f"{min_bytes / bw / per:.4f} of HBM peak")
    for name, s in sorted(dt["ops"].items(), key=lambda kv: -kv[1])[:5]:
        say(f"     op {name[:70]}: {s / reps * 1e6:.1f} us/call")


def phase5(sc):
    from functools import partial

    import jax

    from tpu_pathtracer.ops import trace

    cam = headline_camera()
    name, w, h, b = CELLS["stress"]
    data = jax.device_put(sc[name].compile())
    n = data.packed.tri_pos.shape[0]
    check(trace.resolve_intersector("auto", n) == "bvh8",
          f"stress scene ({n} tris) does not resolve to bvh8")
    original = trace.bvh_fat_intersect
    try:
        for rb in (16384, 65536, 0):
            trace.bvh_fat_intersect = partial(original, ray_batch=rb)
            bench(f"{name} ({n} tris) {w}x{h}x1x{b} bvh8 ray_batch={rb}",
                  data, cam, w, h, 1, b, "auto")
    finally:
        trace.bvh_fat_intersect = original
    name, w, h, b = CELLS["mesh8K"]
    data = jax.device_put(sc[name].compile())
    n = data.packed.tri_pos.shape[0]
    res = {isect: bench(f"{name} ({n} tris) {w}x{h}x1x{b} [{isect}]", data,
                        cam, w, h, 1, b, isect)
           for isect in ("mt_pallas", "bvh8")}
    say(f"   at {n} tris: bvh8 / kernel = "
        f"{res['bvh8'].per_frame_s / res['mt_pallas'].per_frame_s:.3f}")


def phase6(sc):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_pathtracer import diff
    from tpu_pathtracer.scene.types import RenderParams

    data = jax.device_put(sc["default"].compile())
    params = RenderParams.create(headline_camera(), frame=1)
    kw = dict(width=128, height=128, aspect=1.0, samples_per_frame=1,
              max_bounces=2)
    target = diff.render_frame_diff(data, params, **kw)
    wrong = jnp.asarray(np.random.default_rng(0).random(
        data.materials.color.shape), jnp.float32)
    bad = dataclasses.replace(data, materials=dataclasses.replace(
        data.materials, color=wrong))
    loss_p = diff.make_param_loss(diff.make_loss(target, **kw), bad, params,
                                  ["materials.color"])
    _, g = jax.value_and_grad(loss_p)(diff.extract(bad, params,
                                                   ["materials.color"]))
    check(bool(np.isfinite(np.asarray(g["materials.color"])).all()),
          "non-finite gradient")
    t0 = time.perf_counter()
    res = diff.invert(bad, params, target, ["materials.color"], steps=8,
                      learning_rate=5e-2, **kw)
    say(f"   invert albedo 128^2x2: loss {res.losses[0]:.6f} -> "
        f"{res.final_loss:.6f} in 8 steps ({time.perf_counter() - t0:.1f} s "
        "incl. compile)")
    check(res.final_loss < res.losses[0], "loss did not fall")


def phase7():
    import bench
    from tpu_pathtracer.render.benchmark import (
        card_name_and_power_limit,
        device_info,
        headline_record,
    )

    res = bench.headline()
    device = dict(device_info(), card=card_name_and_power_limit())
    rec = headline_record(res, device, 512 * 512 / res.per_frame_s)
    say(json.dumps(rec))
    check(res.ok, f"headline refused: {res.reasons}")


def multi():
    import jax
    import numpy as np

    import test_parallel as tp
    import tpu_pathtracer as pt
    from tpu_pathtracer import diff
    from tpu_pathtracer.parallel import make_mesh
    from tpu_pathtracer.parallel.diffshard import (
        make_sharded_value_and_grad,
        target_sharding,
    )

    check(len(jax.devices()) == 4, f"--multi needs 4 cards, has "
          f"{len(jax.devices())}")
    w, h = MULTI_FRAME
    with Phase(f"M1. {w}x{h} frame, tiles=4 against one card"):
        scene = scenes()["default"]
        cfg = pt.RenderConfig(width=w, height=h, frames=3, max_bounces=4)
        n = scene.compile().packed.tri_pos.shape[0]
        from tpu_pathtracer.ops.trace import resolve_intersector

        say(f"   intersector: {resolve_intersector('auto', n)} ({n} tris)")
        accs = {}
        for label, shard in (("1 card", None),
                             ("tiles=4", pt.ShardConfig(tiles=4))):
            r = pt.Renderer(scene, headline_camera(), cfg,
                            pt.PostConfig(denoise=False), shard=shard)
            r.reset()
            r.render()  # compile
            t0 = time.perf_counter()
            r.render()
            r.render()
            acc = np.asarray(jax.block_until_ready(r.accumulation))
            say(f"   {label}: {(time.perf_counter() - t0) / 2 * 1e3:.2f} "
                "ms/frame (wall, Renderer.render)")
            accs[label] = acc
        a, b = accs["1 card"], accs["tiles=4"]
        diff_px = np.abs(a - b).max(axis=-1)
        say(f"   sharded vs single: bit-identical={np.array_equal(a, b)}, "
            f"max abs diff {diff_px.max():.3e}, "
            f"{(diff_px > 0).mean() * 100:.4f}% pixels differ")
        check(np.array_equal(a, b), "tile-sharded frame differs")
    with Phase("M2. samples=4 estimator against the sequential one"):
        tp.test_sample_shard_estimator_converges_to_sequential(
            tp.make_scene_data())
        say("   within tests/test_parallel.py's statistical bound")
    with Phase("M3. sharded value-and-grad (tiles=4) against one card"):
        sd = tp.make_scene_data()
        kw = dict(width=64, height=64, aspect=1.0, samples_per_frame=1,
                  max_bounces=2)
        params = tp._params(1)
        target = diff.render_frame_diff(sd, params, **kw) * 0.7
        paths = ["materials.color", "env.radiance"]
        loss_p = diff.make_param_loss(diff.make_loss(target, **kw), sd,
                                      params, paths)
        values = diff.extract(sd, params, paths)
        l_ref, g_ref = jax.value_and_grad(loss_p)(values)
        mesh = make_mesh(tiles=4, samples=1)
        vg = make_sharded_value_and_grad(mesh, sd, params, **kw)
        l_sh, g_sh = vg(values, jax.device_put(target,
                                               target_sharding(mesh)))
        np.testing.assert_allclose(float(l_sh), float(l_ref), rtol=1e-5)
        for p in paths:
            a, b = np.asarray(g_sh[p]), np.asarray(g_ref[p])
            say(f"   {p}: max abs diff {np.abs(a - b).max():.3e}")
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-4,
                                       err_msg=p)


def main():
    import jax

    with Phase("0. device"):
        phase0()
    if "--multi" in sys.argv:
        multi()
    else:
        sc = scenes()
        with Phase("1. kernel parity at real widths"):
            phase1(sc)
        with Phase("2. golden snapshots on the card"):
            phase2()
        with Phase("3. kernel against XLA, end to end"):
            out = phase3(sc)
        with Phase("4. post pass"):
            phase4(sc, out["envlit", "mt_pallas"])
        with Phase("5. large scene"):
            phase5(sc)
        with Phase("6. inverse rendering"):
            phase6(sc)
        with Phase("7. headline record"):
            phase7()
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
