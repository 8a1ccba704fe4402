"""Headline benchmark: ray-vs-scene intersection throughput on the default
device, measured honestly.

One "ray" = one ray-vs-scene intersection (W*H pixels x spp x max_bounces
intersections per frame).  Prints ONE JSON line to stdout: rays/s, per-frame
ms, paths/s, compile seconds and the device busy share, stamped with the
device as JAX reports it and the card's name and power limit.

The headline shape is pinned to the reference's default dispatch shape —
512x512 x 1 spp x 4 bounces on the default scene (reference:
src/renderer.ts:39-41 at a 2048-wide canvas -> 512^2 internal;
src/passes/raytrace.ts:697-698) — so numbers stay comparable.  The frame
count is auto-scaled so each timed program runs ~1.5 s; throughput is the
SLOPE between two budget sizes with a linearity gate, a profiler busy-time
cross-check, and a physical-bounds check (tpu_pathtracer/render/benchmark.py).

`python bench.py --full` additionally reports, to stderr, the config sweep
(Cornell-class 256^2, 1K-tri mesh + DoF 512^2, env-lit 1080p with
denoise+tonemap, 100K-tri stress, the 64-spp fixed-seed run) and the mesh
scaling table over the local devices.
"""

from __future__ import annotations

import json
import math
import sys


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def headline(reps=3, deadline=None):
    import jax

    import tpu_pathtracer as pt
    from tpu_pathtracer.render.benchmark import bench_config
    from tpu_pathtracer.scene.envmap import gradient_sky
    from tpu_pathtracer.scene.types import Camera

    W = H = 512
    SPP, BOUNCES = 1, 4
    scene = pt.default_scene(gradient_sky(64, 128))
    data = jax.device_put(scene.compile())
    cam = Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
    res = bench_config(
        data, cam, width=W, height=H, spp=SPP, bounces=BOUNCES, aspect=1.0,
        reps=reps, deadline=deadline, log=log,
    )
    log(
        f"headline 512^2x1sppx4b: {res.rays_per_s:.3e} rays/s  "
        f"{W * H * SPP / res.per_frame_s / 1e6:.1f} Mpaths/s  "
        f"per-frame {res.per_frame_s*1e3:.2f} ms (slope; "
        f"T({res.n1})={res.t_n1_s:.2f}s T({res.n2})={res.t_n2_s:.2f}s, "
        f"spread {res.spread_rel*100:.0f}%, linearity {res.linearity:.2f}, "
        f"busy share {res.busy_share}, compile {res.compile_s:.0f}s)  "
        f"ok={res.ok} {res.reasons}"
    )
    return res


def mesh_scene(segments, sky):
    """A UV sphere of `segments` x segments/2 quads over a ground plane."""
    from tpu_pathtracer.scene import primitives
    from tpu_pathtracer.scene.host import Material, Mesh, Scene, rotation_x

    s = Scene()
    s.add(Mesh(*primitives.sphere(0.5, segments, segments // 2),
               Material(color=(0.8, 0.7, 0.6))))
    s.add(Mesh(*primitives.plane(4, 4), Material(),
               transform=rotation_x(-math.pi / 2)))
    s.set_environment(sky)
    return s


def sweep_configs():
    """(name, scene, camera, width, height, spp, bounces, post) per cell:
    the BASELINE.json configs.  envlit renders true 1920x1080 with the
    denoise+tonemap pass INSIDE the timed frame (the reference draws the
    fullscreen pass every frame, renderer.ts:387)."""
    import tpu_pathtracer as pt
    from tpu_pathtracer.config import PostConfig
    from tpu_pathtracer.scene.envmap import gradient_sky
    from tpu_pathtracer.scene.types import Camera

    sky = gradient_sky(512, 1024)
    cam = Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
    dof_cam = Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45,
                            focal_distance=4.0, aperture=0.1)
    return [
        ("cornell_256", pt.default_scene(sky), cam, 256, 256, 1, 4, None),
        ("mesh1K_dof_512", mesh_scene(32, sky), dof_cam, 512, 512, 1, 4, None),
        ("envlit_1080p", mesh_scene(32, sky), cam, 1920, 1080, 1, 4,
         PostConfig(denoise=True)),
        ("stress100K_512", mesh_scene(320, sky), cam, 512, 512, 1, 6, None),
    ]


def full_sweep():
    import time

    import jax

    import tpu_pathtracer as pt
    from tpu_pathtracer.render.benchmark import (
        bench_config,
        bench_scaling,
        make_budget,
    )
    from tpu_pathtracer.scene.envmap import gradient_sky
    from tpu_pathtracer.scene.types import Camera, RenderParams

    for name, scene, c, w, h, spp, bounces, post in sweep_configs():
        data = jax.device_put(scene.compile())
        res = bench_config(data, c, width=w, height=h, spp=spp,
                           bounces=bounces, aspect=w / h, reps=3, post=post,
                           log=log)
        log(json.dumps({
            "cell": name, "rays_per_s": res.rays_per_s,
            "per_frame_ms": res.per_frame_s * 1e3,
            "paths_per_s": w * h * spp / res.per_frame_s,
            "busy_share": res.busy_share, "compile_s": res.compile_s,
            "linearity": res.linearity, "ok": res.ok,
        }))

    # BASELINE configs[0] to the letter: 256^2, 4 bounces, 64 spp, fixed
    # seed, run once end to end and recorded as (total time, image stats).
    cam = Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45)
    data = jax.device_put(pt.default_scene(gradient_sky(512, 1024)).compile())
    budget64 = make_budget(256, 256, 1, 4, 1.0)
    params = RenderParams.create(cam, frame=1)
    jax.block_until_ready(budget64(data, params, 64))  # compile
    t0 = time.perf_counter()
    img = jax.device_get(budget64(data, params, 64))
    t64 = time.perf_counter() - t0
    log(json.dumps({
        "cell": "cornell_256_64spp_fixedseed", "total_s": t64,
        "rays_per_s": 256 * 256 * 64 * 4 / t64,
        "mean_rgb": [float(m) for m in img.mean(axis=(0, 1))],
    }))

    scene = pt.default_scene(gradient_sky(64, 128))
    bench_scaling(jax.device_put(scene.compile()), cam, width=256, height=256,
                  spp=1, bounces=4, log=log)


def main() -> None:
    """Headline first, its JSON line printed the moment it exists; the
    `--full` extras run afterwards and can be cut without losing it."""
    import os
    import time

    from tpu_pathtracer.render.benchmark import (
        card_name_and_power_limit,
        device_info,
        headline_record,
    )
    from tpu_pathtracer.utils.compcache import enable_compilation_cache

    t_start = time.perf_counter()
    deadline = t_start + float(os.environ.get("BENCH_DEADLINE_S", "900"))
    log(f"compilation cache: {enable_compilation_cache()}")
    device = device_info()
    device["card"] = card_name_and_power_limit()
    log(f"device: {device}")
    res = headline(deadline=deadline)
    rec = headline_record(res, device, 512 * 512 / res.per_frame_s)
    print(json.dumps(rec), flush=True)
    if "--full" in sys.argv:
        full_sweep()


if __name__ == "__main__":
    main()
