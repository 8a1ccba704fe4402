"""Trustworthy benchmark harness — the rays/s measurement used by both the
repo-root bench.py and `cli benchmark` (one definition of the headline
metric).

One "ray" = one ray-vs-scene intersection: W*H pixels x spp x max_bounces
intersections per frame (every bounce iteration intersects the full scene
for the whole batch).

Methodology:

  1. The whole budget runs inside ONE jitted ``lax.fori_loop`` over frames
     (no per-frame dispatch), and every timed repetition ends with
     ``jax.block_until_ready`` on the accumulated image.
  2. We time two budget sizes n and 2n (medians over reps) and use the
     SLOPE ``(T(2n) - T(n)) / n`` as the per-frame time: the fixed launch
     and synchronisation cost cancels.
  3. Linearity gate: the incremental slope must match the per-frame time
     implied by T(2n)/2 within ``linearity_tol`` — if doubling the work
     does not roughly double the time, the number is refused.
  4. Profiler cross-check: one run executes under ``jax.profiler.trace``
     and the device busy time and idle share of that window are reported
     next to the wall-clock slope (utils/devtime.py; the analogue of the
     reference's GPU timestamp queries, src/timing.ts:28-146).
  5. Physical sanity: the implied FLOP/s and memory traffic at the measured
     rate are checked against the device's published peaks (`PEAKS`);
     numbers that exceed hardware are refused (``ok=False``).  A device
     missing from the table is an error; the CPU backend has no entry and
     skips this gate.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

# Published peaks by jax `device_kind`, at the card's full power limit.
# H100 SXM5: NVIDIA H100 Tensor Core GPU data sheet — 67 TFLOP/s float32
# outside the tensor cores, 80 GB HBM3 at 3.35 TB/s, 700 W.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops_f32": 67e12, "hbm_bps": 3.35e12},
}
# Minimum honest per-ray-bounce cost model: one node/triangle fetch (32 B)
# and ~60 flops of intersection math.
MIN_BYTES_PER_RAY = 32.0
MIN_FLOPS_PER_RAY = 60.0


def device_peaks(device=None) -> Optional[dict]:
    """Published peaks of `device` (default: the first device); None on the
    CPU backend.  An accelerator missing from PEAKS is an error."""
    import jax

    device = device if device is not None else jax.devices()[0]
    if device.platform == "cpu":
        return None
    if device.device_kind not in PEAKS:
        raise ValueError(
            f"no published peaks for device_kind {device.device_kind!r}: "
            "add its data-sheet values to render.benchmark.PEAKS")
    return PEAKS[device.device_kind]


def card_name_and_power_limit() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, run
    as a child process (no JAX in it); None where there is no nvidia-smi."""
    import shutil
    import subprocess

    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def device_info() -> dict:
    """The device a result was measured on, as JAX reports it."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


@dataclasses.dataclass
class BenchResult:
    rays_per_s: float
    per_frame_s: float  # slope-based
    t_n1_s: float
    t_n2_s: float
    n1: int
    n2: int
    spread_rel: float  # (max-min)/median at n2
    linearity: float  # slope vs T(n2)/n2 agreement ratio (1.0 = perfect)
    device_per_frame_s: Optional[float]  # profiler busy time, None on CPU
    busy_share: Optional[float]  # device busy / window, None on CPU
    compile_s: float
    ok: bool
    reasons: list

    @property
    def rays_per_frame(self) -> int:
        return self._rays_per_frame

    _rays_per_frame: int = 0


def make_budget(width: int, height: int, spp: int, bounces: int, aspect=None,
                intersector: str = "auto", post=None):
    """Build fn(scene, params0, n_frames) rendering n frames in ONE jitted
    fori_loop (progressive accumulation, like the reference's full render
    budget, renderer.ts:366-395) — returns the accumulated (H, W, 3) image.

    ``n_frames`` is a TRACED scalar (dynamic ``fori_loop`` bound), so ONE
    compiled program serves every frame count, and the whole
    calibrate-and-measure sequence pays for exactly one compile.  (The loop's trip count is data-dependent, so
    XLA on the GPU reads the predicate back to the host each iteration.)

    ``post``: optional PostConfig.  When given, every frame ALSO runs the
    fullscreen-pass equivalent (denoise + tonemap, post/pipeline.py) on the
    accumulated image inside the timed loop — the reference draws the
    fullscreen pass every frame (renderer.ts:387), so BASELINE.json's
    "tone-mapping + denoise pass" config times it in-frame.  The display
    image is carried in the loop state (so XLA cannot dead-code it) and
    returned alongside the accumulator."""
    import jax
    import jax.numpy as jnp

    from ..ops.trace import accumulate, render_frame

    aspect = aspect if aspect is not None else width / height
    if post is not None:
        from ..post import postprocess

    @jax.jit
    def budget(scene_d, params0, n_frames):
        def body(f, carry):
            acc, disp = carry
            p = dataclasses.replace(params0, frame=(f + 1).astype(jnp.uint32))
            img = render_frame(scene_d, p, width=width, height=height,
                               aspect=aspect, samples_per_frame=spp,
                               max_bounces=bounces, intersector=intersector)
            acc = accumulate(acc, img, p.frame, enabled=True)
            if post is not None:
                disp = postprocess(acc, post)
            return acc, disp

        zeros = jnp.zeros((height, width, 3), jnp.float32)
        acc, disp = jax.lax.fori_loop(
            0, jnp.asarray(n_frames, jnp.int32), body, (zeros, zeros)
        )
        return disp if post is not None else acc

    return budget


def _timed(fn, reps: int) -> list:
    """Wall times of fn() up to `jax.block_until_ready` of its output."""
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return ts


def measure_budget(
    budget,
    scene_data,
    cam,
    *,
    width: int,
    height: int,
    spp: int,
    bounces: int,
    reps: int = 3,
    target_seconds: float = 1.5,
    max_frames: int = 512,
    linearity_tol: float = 0.15,
    profile: bool = True,
    deadline: Optional[float] = None,
    log: Callable[[str], None] = lambda s: None,
) -> BenchResult:
    """Measure per-frame time of `budget` with the slope method (see module
    docstring).  Returns a BenchResult; `ok=False` means the number failed
    the linearity or physics gate and must not be published as a headline.

    Calibration is latency-aware: n1 is sized so the fixed launch and
    sync latency (estimated from T(1) and T(2)) is <=10% of T(n1), which
    keeps the linearity ratio meaningful; the default tolerance band is
    |1 - linearity| <= 0.15.

    ``deadline`` (absolute ``time.perf_counter()`` value) guards the
    optional extras: once past it, the profiler cross-check is skipped so
    a slow compile can never starve the headline number."""
    import jax
    import numpy as np

    from ..scene.types import RenderParams

    params = RenderParams.create(cam, frame=1)

    # --- compile + calibrate n1 ------------------------------------------
    peaks = device_peaks()
    t0 = time.perf_counter()
    jax.block_until_ready(budget(scene_data, params, 1))
    compile_s = time.perf_counter() - t0
    t1 = min(_timed(lambda: budget(scene_data, params, 1), 2))
    jax.block_until_ready(budget(scene_data, params, 2))
    t2 = min(_timed(lambda: budget(scene_data, params, 2), 2))
    # T(n) ~= latency + n * frame; require T(n1) >= 10x latency.
    frame_est = max(t2 - t1, 1e-5)
    latency_est = max(2 * t1 - t2, 0.0)
    n1 = int(
        max(
            1,
            min(
                max_frames // 2,
                max(
                    round(target_seconds / frame_est),
                    np.ceil(9.0 * latency_est / frame_est),
                ),
            ),
        )
    )
    n2 = 2 * n1
    log(
        f"calibrate: T(1)={t1*1e3:.1f}ms T(2)={t2*1e3:.1f}ms "
        f"(frame~{frame_est*1e3:.1f}ms latency~{latency_est*1e3:.1f}ms) "
        f"-> n1={n1}, n2={n2}"
    )

    # --- timed points (medians) ------------------------------------------
    # warm both budget sizes before timing (same compiled program — the
    # dynamic-bound fori_loop means these are plain executions, not compiles)
    jax.block_until_ready(budget(scene_data, params, n1))
    jax.block_until_ready(budget(scene_data, params, n2))
    ts1 = sorted(_timed(lambda: budget(scene_data, params, n1), reps))
    ts2 = sorted(_timed(lambda: budget(scene_data, params, n2), reps))
    t_n1 = ts1[len(ts1) // 2]
    t_n2 = ts2[len(ts2) // 2]
    spread = (ts2[-1] - ts2[0]) / t_n2
    slope = (t_n2 - t_n1) / (n2 - n1)

    reasons = []
    ok = True
    if slope <= 0:
        ok = False
        reasons.append(
            f"non-increasing time: T({n1})={t_n1:.3f}s T({n2})={t_n2:.3f}s"
        )
        slope = t_n2 / n2  # fall back to the most conservative estimate

    # --- linearity gate ----------------------------------------------------
    # If the fixed overhead is small relative to the work, T(n2)/n2 and the
    # slope must agree; a large gap means the measurement is latency-bound
    # or sublinear (dispatch artifact).
    linearity = slope / (t_n2 / n2) if t_n2 > 0 else 0.0
    if abs(1.0 - linearity) > linearity_tol:
        if t_n2 < 1.5 * t_n1:
            # Doubling the work barely moved the wall time: the measurement
            # is dispatch/latency-bound, not compute-bound — refuse it.
            ok = False
            reasons.append(
                f"linearity fail: T({n1})={t_n1:.3f}s vs T({n2})={t_n2:.3f}s "
                f"(slope {slope*1e3:.2f}ms, T(n2)/n2 {t_n2/n2*1e3:.2f}ms, "
                f"ratio {linearity:.2f})"
            )
        # Publish the conservative (slower) of the two estimates.
        slope = max(slope, t_n2 / n2)

    # --- profiler cross-check ---------------------------------------------
    # Runs on the ALREADY-COMPILED n1 program (one ~target_seconds
    # execution + profiler overhead), so it is cheap enough to grant a
    # grace window past the deadline: the deadline exists to stop slow
    # COMPILES from starving the headline JSON, and by this point the only
    # compile has happened.  The CPU backend has no device trace.
    device_per_frame = None
    busy_share = None
    grace_s = 120.0
    if peaks is None:
        profile = False
    if (profile and deadline is not None
            and time.perf_counter() > deadline + grace_s):
        log("profiler cross-check skipped: past deadline grace")
        profile = False
    if profile:
        from ..utils.devtime import device_time

        dt = device_time(lambda: budget(scene_data, params, n1))
        if not dt["ok"]:
            raise RuntimeError("profiler trace holds no device operations")
        device_per_frame = dt["busy_s"] / n1
        busy_share = dt["busy_s"] / dt["window_s"]
        log(
            f"profiler: device busy {device_per_frame*1e3:.3f} ms/frame, "
            f"busy share {busy_share:.3f} (wall slope "
            f"{slope*1e3:.3f} ms/frame)"
        )
        if device_per_frame > 2.0 * slope:
            ok = False
            reasons.append(
                f"device time {device_per_frame*1e3:.2f}ms/frame exceeds "
                f"wall slope {slope*1e3:.2f}ms/frame by >2x: wall timing "
                "did not capture execution"
            )
            slope = device_per_frame

    # --- physics gate -------------------------------------------------------
    rays_per_frame = width * height * spp * bounces
    rays_per_s = rays_per_frame / slope if slope > 0 else 0.0
    implied_flops = rays_per_s * MIN_FLOPS_PER_RAY
    implied_bps = rays_per_s * MIN_BYTES_PER_RAY
    if peaks is None:
        log("physics gate skipped: CPU backend has no published peaks")
    elif (implied_flops > peaks["flops_f32"]
          or implied_bps > peaks["hbm_bps"]):
        ok = False
        reasons.append(
            f"exceeds hardware: {implied_flops/1e12:.1f} TFLOP/s or "
            f"{implied_bps/1e9:.0f} GB/s implied at {rays_per_s:.2e} rays/s"
        )

    res = BenchResult(
        rays_per_s=rays_per_s,
        per_frame_s=slope,
        t_n1_s=t_n1,
        t_n2_s=t_n2,
        n1=n1,
        n2=n2,
        spread_rel=spread,
        linearity=linearity,
        device_per_frame_s=device_per_frame,
        busy_share=busy_share,
        compile_s=compile_s,
        ok=ok,
        reasons=reasons,
    )
    res._rays_per_frame = rays_per_frame
    return res


def bench_config(
    scene_data,
    cam,
    *,
    width: int,
    height: int,
    spp: int,
    bounces: int,
    aspect: Optional[float] = None,
    reps: int = 3,
    target_seconds: float = 1.5,
    intersector: str = "auto",
    post=None,
    deadline: Optional[float] = None,
    log: Callable[[str], None] = lambda s: None,
) -> BenchResult:
    """Convenience: build the budget program and measure it."""
    budget = make_budget(width, height, spp, bounces, aspect, intersector,
                         post=post)
    return measure_budget(
        budget, scene_data, cam, width=width, height=height, spp=spp,
        bounces=bounces, reps=reps, target_seconds=target_seconds,
        deadline=deadline, log=log,
    )


def bench_scaling(
    scene_data,
    cam,
    *,
    width: int = 256,
    height: int = 256,
    spp: int = 1,
    bounces: int = 4,
    tile_counts=(1, 2, 4, 8),
    reps: int = 3,
    target_seconds: float = 1.0,
    log: Callable[[str], None] = lambda s: None,
) -> list:
    """Mesh-size scaling table: slope-timed per-frame cost of the sharded
    whole-budget render at growing tile counts, with parallel efficiency
    relative to tiles=1.

    Runs on whatever devices exist: the 8-virtual-device CPU mesh in tests
    (methodology check — virtual devices share physical cores, so CPU
    efficiency numbers are indicative only) and real cards when present.
    Returns [{tiles, per_frame_s, efficiency}, ...].
    """
    import jax

    from ..parallel import sharded
    from ..parallel.mesh import make_mesh
    from ..scene.types import RenderParams

    ndev = len(jax.devices())
    rows = []
    base = None
    for tiles in tile_counts:
        if tiles > ndev or height % tiles:
            log(f"scaling: skip tiles={tiles} (devices={ndev}, height={height})")
            continue
        mesh = make_mesh(tiles=tiles, samples=1)
        scene_t = jax.device_put(scene_data)

        # ONE dynamic-bound program per tile count (render_all takes the
        # frame count as a traced fori_loop bound).
        render_all = sharded.make_sharded_render_all(
            mesh, width=width, height=height, aspect=width / height,
            samples_per_frame=spp, max_bounces=bounces,
        )

        def budget(scene, params, n, _render=render_all):
            return _render(scene, params, n)

        res = measure_budget(
            budget, scene_t, cam, width=width, height=height, spp=spp,
            bounces=bounces, reps=reps, target_seconds=target_seconds,
            profile=False, log=log,
        )
        if base is None:
            base = res.per_frame_s
        eff = base / (res.per_frame_s * tiles) if res.per_frame_s > 0 else 0.0
        rows.append({"tiles": tiles, "per_frame_s": res.per_frame_s,
                     "efficiency": eff, "ok": res.ok})
        log(f"scaling tiles={tiles}: {res.per_frame_s*1e3:.2f} ms/frame, "
            f"efficiency {eff*100:.0f}% (ok={res.ok})")
    return rows


def headline_record(result: BenchResult, device: dict,
                    paths_per_s: Optional[float] = None) -> dict:
    """The one-line JSON record of a measurement, stamped with `device`
    (`device_info()`, plus e.g. the card's power limit).

    `paths_per_s` is the useful-work companion metric (completed camera
    paths per second = W*H*spp / frame time): rays/s counts every bounce
    iteration over the full lane set, which rewards re-traversing lanes
    that terminated early; paths/s does not."""
    rec = {
        "metric": f"ray_scene_intersections_per_s_{device['platform']}",
        "value": result.rays_per_s,
        "unit": "rays/s",
        "device": device,
        "per_frame_ms": result.per_frame_s * 1e3,
        "compile_s": result.compile_s,
        "linearity": result.linearity,
    }
    if result.device_per_frame_s is not None:
        rec["device_per_frame_ms"] = result.device_per_frame_s * 1e3
        rec["busy_share"] = result.busy_share
    if paths_per_s is not None:
        rec["paths_per_s"] = paths_per_s
    if not result.ok:
        rec["suspect"] = True
        rec["reasons"] = result.reasons
    return rec
