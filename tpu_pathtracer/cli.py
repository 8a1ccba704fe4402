"""Command-line harness: the replacement for the reference's
browser UI shell (reference: src/main.ts — Tweakpane panel, screenshot
button, progress bar, device diagnostic).

Commands:
  render     scene -> PNG, with the full parameter surface of the reference
             UI (resolution scale, frames, spp, bounces, tonemap, denoise,
             camera pose/fov/focal-distance/aperture, env map/intensity/
             rotation) plus checkpoint/resume.
  benchmark  rays/s measurement (JSON line, same metric as bench.py).
  invert     inverse-rendering demo: recover a perturbed material color from
             a rendered target (BASELINE.json configs[4]).
  export     convert/compress scenes to .glb, optionally Draco-compressed
             through the native codec (csrc/draco_codec.cpp).
  info       backend/device diagnostic (reference: Renderer.diagnostic(),
             src/renderer.ts:470-489).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _add_render_args(p: argparse.ArgumentParser) -> None:
    from .config import INTERSECTORS

    p.add_argument("--scene", default="default",
                   help="'default' (plane+box+sphere, src/main.ts:49-75) or a .glb/.gltf path")
    p.add_argument("--env", default="gradient",
                   help="'gradient', 'black', 'sky[:elevation=30,azimuth=90,"
                        "turbidity=3]' (Preetham sun-sky), or a .hdr path")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--scale", type=float, default=1.0,
                   help="internal resolution scaling factor (renderer.ts:39)")
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--spp", type=int, default=1, help="samples per frame")
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--tonemap", choices=["none", "aces", "reinhard"], default="aces")
    p.add_argument("--denoise", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--env-intensity", type=float, default=1.0)
    p.add_argument("--env-rotation", type=float, default=0.0, help="degrees")
    p.add_argument("--camera-position", type=float, nargs=3, default=(0.0, 1.0, 4.0))
    p.add_argument("--look-at", type=float, nargs=3, default=(0.0, 0.5, 0.0))
    p.add_argument("--fov", type=float, default=45.0)
    p.add_argument("--focal-distance", type=float, default=1.0)
    p.add_argument("--aperture", type=float, default=0.0)
    p.add_argument("--env-importance", action="store_true",
                   help="enable CDF importance sampling of the environment")
    p.add_argument("--intersector", choices=list(INTERSECTORS),
                   default="auto",
                   help="intersection backend: all-pairs Möller–Trumbore (mt,"
                        " or mt_pallas: the fused GPU kernel) or BVH"
                        " traversal (bvh, bvh8); auto picks by scene size"
                        " and backend")
    p.add_argument("--blue-noise", action="store_true",
                   help="blue-noise low-discrepancy AA jitter (lower "
                        "low-frequency error at small sample counts)")
    p.add_argument("--shard-tiles", type=int, default=1,
                   help="shard image rows over this many devices")
    p.add_argument("--shard-samples", type=int, default=1,
                   help="shard the per-frame sample budget over this many devices")


def _build_scene(args):
    import numpy as np

    from .io.hdr import read_hdr
    from .scene.envmap import gradient_sky
    from .scene.host import Material, Scene, default_scene

    if args.env == "gradient":
        env = gradient_sky(512, 1024)
    elif args.env == "black":
        env = np.zeros((8, 16, 3), np.float32)
    elif args.env == "sky" or args.env.startswith("sky:"):
        from .scene.sky import parse_sky_spec, sun_sky

        env = sun_sky(512, 1024, **parse_sky_spec(args.env))
    else:
        env = read_hdr(args.env)

    if args.scene == "default":
        scene = default_scene(env)
    else:
        from .io.gltf import load_gltf

        scene = Scene()
        for m in load_gltf(args.scene):
            scene.add(m)
        scene.set_environment(env)
    return scene


def _build_renderer(args):
    from . import PostConfig, RenderConfig, Renderer, Tonemap
    from .scene.types import Camera

    scene = _build_scene(args)
    cam = Camera.create(
        position=tuple(args.camera_position),
        look_at=tuple(args.look_at),
        fov=args.fov,
        focal_distance=args.focal_distance,
        aperture=args.aperture,
    )
    cfg = RenderConfig(
        width=args.width, height=args.height, scaling_factor=args.scale,
        frames=args.frames, samples_per_frame=args.spp, max_bounces=args.bounces,
        intersector=args.intersector,
        blue_noise=getattr(args, "blue_noise", False),
    )
    post = PostConfig(denoise=args.denoise, tonemap=Tonemap[args.tonemap.upper()])
    shard = None
    tiles = getattr(args, "shard_tiles", 1)
    samples = getattr(args, "shard_samples", 1)
    if tiles * samples > 1:
        from . import ShardConfig

        shard = ShardConfig(tiles=tiles, samples=samples)
    r = Renderer(scene, cam, cfg, post,
                 env_importance=args.env_importance,
                 enable_timing=getattr(args, "timing", False),
                 shard=shard)
    import math

    r.env_intensity = args.env_intensity
    r.env_rotation = math.radians(args.env_rotation)
    return r


def cmd_render(args) -> int:
    import contextlib

    import jax

    profile_cm = (
        jax.profiler.trace(args.profile)
        if getattr(args, "profile", None)
        else contextlib.nullcontext()
    )
    with profile_cm:
        return _render_body(args)


def _render_body(args) -> int:
    import jax

    r = _build_renderer(args)
    metrics = None
    if getattr(args, "metrics", None):
        from .render.metrics import MetricsLogger

        metrics = MetricsLogger(r, path=None if args.metrics == "-" else args.metrics)
    if args.resume:
        r.load_state(args.resume)
        print(f"resumed at frame {r.frame}/{args.frames}", file=sys.stderr)
    else:
        r.reset()

    last_pct = [-1]

    def on_progress(progress):
        pct = int(progress * 100)
        if pct != last_pct[0] and pct % 10 == 0:
            print(f"  {pct:3d}%  frame {r.frame - 1}/{args.frames} "
                  f"({r.samples} spp)", file=sys.stderr)
            last_pct[0] = pct

    unsub = r.on("progress", on_progress)
    t0 = time.perf_counter()
    ck_every = getattr(args, "checkpoint_every", 0) or 0
    r.render_all(
        checkpoint_path=args.checkpoint if ck_every else None,
        checkpoint_every=ck_every,
    )
    jax.block_until_ready(r.accumulation)
    unsub()
    if metrics is not None:
        metrics.close()
    dt = time.perf_counter() - t0

    if args.checkpoint:
        r.save_state(args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}", file=sys.stderr)
    if args.output.endswith(".hdr"):
        # linear radiance export at render resolution (no tonemap/denoise)
        import numpy as np

        from .io.hdr import write_hdr

        write_hdr(args.output, np.asarray(r.accumulation)[::-1])
    else:
        r.screenshot(args.output)
    spp = args.frames * args.spp
    print(f"{args.output}: {args.width}x{args.height} {spp}spp in {dt:.2f}s "
          f"({r.config.scaled_width * r.config.scaled_height * spp / dt / 1e6:.3f} "
          f"Mpixel-samples/s)", file=sys.stderr)
    if args.timing:
        for name, timer in r.timings.items():
            print(f"  {name:11s} {timer.value:10.1f} us/frame", file=sys.stderr)
    return 0


def cmd_benchmark(args) -> int:
    import sys

    import jax

    from .render.benchmark import bench_config, device_info, headline_record

    r = _build_renderer(args)
    scene_data = jax.device_put(r.scene_data)
    W, H = r.config.scaled_width, r.config.scaled_height
    res = bench_config(
        scene_data, r.camera, width=W, height=H, spp=args.spp,
        bounces=args.bounces, aspect=args.width / args.height,
        reps=args.reps, log=lambda s: print(s, file=sys.stderr),
    )
    print(json.dumps(headline_record(res, device_info())))
    return 0


def cmd_invert(args) -> int:
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from . import diff
    from .scene.types import Camera, RenderParams

    r = _build_renderer(args)
    scene_data = r.scene_data
    params = RenderParams.create(r.camera, frame=1)
    kw = dict(width=r.config.scaled_width, height=r.config.scaled_height,
              aspect=args.width / args.height, samples_per_frame=args.spp,
              max_bounces=args.bounces)

    target = diff.render_frame_diff(scene_data, params, **kw)

    rng = np.random.default_rng(args.seed)
    n_mat = scene_data.materials.color.shape[0]
    wrong = jnp.asarray(rng.random((n_mat, 3)), jnp.float32)
    bad = dataclasses.replace(
        scene_data,
        materials=dataclasses.replace(scene_data.materials, color=wrong),
    )
    print(f"optimizing materials.color from random init, {args.steps} steps...",
          file=sys.stderr)
    tiles = getattr(args, "shard_tiles", 1)
    if tiles > 1:
        from .parallel import make_mesh
        from .parallel.diffshard import invert_sharded

        res = invert_sharded(
            make_mesh(tiles=tiles, samples=1), bad, params, target,
            ["materials.color"], steps=args.steps, learning_rate=args.lr, **kw)
    else:
        res = diff.invert(bad, params, target, ["materials.color"],
                          steps=args.steps, learning_rate=args.lr, **kw)
    true_c = np.asarray(scene_data.materials.color)
    rec = np.asarray(res.values["materials.color"])
    err = float(np.abs(rec - true_c).max())
    print(json.dumps({
        "metric": "invert_final_loss",
        "value": res.final_loss,
        "loss_start": res.losses[0],
        "color_max_abs_err": err,
    }))
    return 0 if res.final_loss < res.losses[0] * 0.5 else 1


def cmd_view(args) -> int:
    """Interactive viewer (the reference's browser app, src/main.ts)."""
    import math

    from .config import PostConfig, RenderConfig, ShardConfig, Tonemap
    from .utils.orbit import OrbitCamera
    from .viewer import ViewerSession, serve

    cfg = RenderConfig(
        width=args.width, height=args.height, scaling_factor=args.scale,
        frames=args.frames, samples_per_frame=args.spp,
        max_bounces=args.bounces,
        intersector=args.intersector,
        blue_noise=getattr(args, "blue_noise", False),
    )
    post = PostConfig(denoise=args.denoise, tonemap=Tonemap[args.tonemap.upper()])
    shard = None
    if args.shard_tiles * args.shard_samples > 1:
        shard = ShardConfig(tiles=args.shard_tiles, samples=args.shard_samples)
    scene = None
    if args.scene != "default":
        from .io.gltf import load_gltf, normalize_meshes
        from .scene.host import Scene

        scene = Scene()
        for m in normalize_meshes(load_gltf(args.scene)):
            scene.add(m)
    orbit = OrbitCamera(
        target=tuple(args.look_at),
        radius=float(np_norm(args.camera_position, args.look_at)),
        fov=args.fov, focal_distance=args.focal_distance,
        aperture=args.aperture,
    )
    session = ViewerSession(config=cfg, post=post, scene=scene, orbit=orbit,
                            shard=shard)
    if args.env != "gradient":
        if args.env == "black":
            session.set_env("black")
        else:
            with open(args.env, "rb") as f:
                session.load_env_hdr(f.read(), name=args.env)
    if args.env_intensity != 1.0 or args.env_rotation != 0.0:
        session.renderer.env_intensity = args.env_intensity
        session.renderer.env_rotation = math.radians(args.env_rotation)
    serve(host=args.host, port=args.port, session=session)
    return 0


def np_norm(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(np.asarray(a, float) - np.asarray(b, float)))


def cmd_export(args) -> int:
    """Convert / compress a scene to .glb (optionally Draco-compressed via
    the native codec, csrc/draco_codec.cpp)."""
    import os

    from .io.gltf import load_gltf, save_glb

    if args.scene == "default":
        import numpy as np

        from .scene.host import default_scene

        meshes = default_scene(np.zeros((8, 16, 3), np.float32)).meshes
    else:
        meshes = load_gltf(args.scene, normalize=not args.no_normalize)
    save_glb(meshes, args.output, draco=args.draco,
             draco_position_bits=args.draco_bits,
             draco_normal_bits=args.draco_normal_bits)
    tris = sum(len(m.indices) for m in meshes)
    print(f"{args.output}: {len(meshes)} meshes, {tris} triangles, "
          f"{os.path.getsize(args.output)} bytes"
          + (" (draco)" if args.draco else ""), file=sys.stderr)
    return 0


def cmd_info(args) -> int:
    import jax

    print(f"jax {jax.__version__}")
    print(f"default backend: {jax.default_backend()}")
    for d in jax.devices():
        print(f"  {d.id}: {d.device_kind} ({d.platform})")
    return 0


def main(argv=None) -> int:
    # Persistent compilation cache: the headline program compiles in
    # minutes cold (BENCH_r02: 229 s); warm runs load from disk instead.
    from .utils.compcache import enable_compilation_cache

    enable_compilation_cache()
    parser = argparse.ArgumentParser(
        prog="tpu_pathtracer",
        description="Differentiable progressive path tracer (JAX)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render a scene to PNG")
    _add_render_args(p)
    p.add_argument("--output", "-o", default="render.png")
    p.add_argument("--checkpoint", default=None,
                   help="save accumulation state to this .npz after rendering")
    p.add_argument("--resume", default=None,
                   help="resume accumulation state from this .npz")
    p.add_argument("--timing", action="store_true",
                   help="per-pass timing meters (reference: src/timing.ts)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler (xprof) trace of the render")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="emit JSONL metrics to PATH ('-' for stderr)")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="with --checkpoint: persist state every N frames "
                        "(preemption-safe progressive render)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("benchmark", help="measure rays/s (one JSON line)")
    _add_render_args(p)
    p.add_argument("--reps", type=int, default=3)
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("invert", help="inverse-rendering demo (recover colors)")
    _add_render_args(p)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_invert)

    p = sub.add_parser("view", help="interactive viewer (browser page)")
    _add_render_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8790)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("export",
                       help="convert/compress a scene to .glb (opt. Draco)")
    p.add_argument("--scene", default="default",
                   help="'default' or a .glb/.gltf path")
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--draco", action="store_true",
                   help="KHR_draco_mesh_compression via the native codec")
    p.add_argument("--draco-bits", type=int, default=14, metavar="N",
                   help="position quantization bits (0 = lossless)")
    p.add_argument("--draco-normal-bits", type=int, default=10, metavar="N")
    p.add_argument("--no-normalize", action="store_true",
                   help="keep source units (skip unit-scale normalization)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("info", help="device diagnostic")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
