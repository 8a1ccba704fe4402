"""The Renderer orchestrator: progressive frame loop, state machine, events.

Re-implements the reference Renderer's public contract
(reference: src/renderer.ts:20-533) the JAX way:

  * progressive state machine `idle | sampling | paused` with
    start/pause/reset and a 1-based frame counter whose overflow past
    `frames` flips to idle and emits 'complete' (renderer.ts:42, 342-348,
    397-444),
  * `render()` advances at most one progressive frame; the accumulated image
    persists and can be displayed while paused (renderer.ts:366-395),
  * event bus with on/off/emit for reset/start/pause/progress/complete
    (renderer.ts:446-468),
  * `progress = frame / (frames + 1)` (renderer.ts:334-336),
  * reset discards accumulation history (the JAX collapse of the reference's
    "recreate textures + rebind everything" invalidation fan-out, SURVEY §3.3),
  * per-pass timing meters (raytrace/accumulate/fullscreen equivalents),
  * scene dirty-flag compile: the device scene is rebuilt only when
    scene.needs_update is set (raytrace.ts:392-394).

Differences by design: buffers are JAX values (no bind groups to rebuild);
the raytrace + accumulate passes fuse into one jitted, donated step unless
per-pass timing is enabled.
"""

from __future__ import annotations


from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PostConfig, RenderConfig
from ..ops.trace import accumulate as accumulate_op
from ..ops.trace import render_frame
from ..post import postprocess
from ..scene.host import Scene
from ..scene.types import Camera, RenderParams, SceneData
from .timing import PassTimer

Event = str  # 'reset' | 'start' | 'pause' | 'progress' | 'complete'

# Jitted fullscreen pass for the timed path (PostConfig is a frozen,
# hashable dataclass -> one compile per distinct config).
_jit_postprocess = jax.jit(postprocess, static_argnums=(1, 2, 3))


def make_frame_step(width: int, height: int, aspect: float, samples_per_frame: int,
                    max_bounces: int, accumulate: bool, env_importance: bool = False,
                    intersector: str = "auto", blue_noise=None):
    """Build the fused jitted progressive step:
    raytrace one frame + fold it into the accumulation buffer (donated)."""

    def step(scene: SceneData, params: RenderParams, acc: jax.Array) -> jax.Array:
        frame_img = render_frame(
            scene,
            params,
            width=width,
            height=height,
            aspect=aspect,
            samples_per_frame=samples_per_frame,
            max_bounces=max_bounces,
            env_importance=env_importance,
            intersector=intersector,
            blue_noise=blue_noise,
        )
        return accumulate_op(acc, frame_img, params.frame, enabled=accumulate)

    return jax.jit(step, donate_argnums=(2,))


class Renderer:
    def __init__(
        self,
        scene: Scene,
        camera: Camera,
        config: RenderConfig = RenderConfig(),
        post: PostConfig = PostConfig(),
        *,
        env_importance: bool = False,
        enable_timing: bool = False,
        shard=None,
    ) -> None:
        """`shard`: optional ShardConfig — renders on a ('tiles','samples')
        device mesh (parallel/): rows shard over tiles (bit-identical to the
        single-device render), the per-frame sample budget shards over
        samples with a psum.  Requires tiles*samples <= len(jax.devices())
        and height % tiles == 0."""
        from ..utils.compcache import enable_compilation_cache

        enable_compilation_cache()
        self.scene = scene
        self.camera = camera
        self._config = config
        self.post = post
        self.env_importance = env_importance
        self.enable_timing = enable_timing
        self.shard = shard
        self._mesh = None
        if shard is not None and shard.num_devices > 1:
            from ..parallel import make_mesh

            self._mesh = make_mesh(tiles=shard.tiles, samples=shard.samples)

        self.status: str = "idle"
        self._frame: int = 1
        self.env_intensity: float = 1.0
        self.env_rotation: float = 0.0

        self.timings: Dict[str, PassTimer] = {
            "raytrace": PassTimer("raytrace"),
            "accumulate": PassTimer("accumulate"),
            "fullscreen": PassTimer("fullscreen"),
        }
        self._listeners: Dict[Event, List[Callable]] = {}

        self._scene_data: Optional[SceneData] = None
        self._step = None
        self._acc: Optional[jax.Array] = None
        # Jitted-step memo keyed by the config fields that shape the traced
        # program: toggling an option back to an already-seen value reuses
        # the existing jit wrapper (and its compiled executable) instead of
        # retracing.
        self._step_cache: Dict[tuple, tuple] = {}
        self._rebuild()

    # ------------------------------------------------------------- config

    @property
    def config(self) -> RenderConfig:
        return self._config

    @config.setter
    def config(self, value: RenderConfig) -> None:
        self._config = value
        self._rebuild()
        self.reset()

    def _rebuild(self) -> None:
        c = self._config
        key = (
            c.scaled_width, c.scaled_height, c.width, c.height,
            c.samples_per_frame, c.max_bounces, c.accumulate, c.intersector,
            c.blue_noise, self.env_importance,
        )
        cached = self._step_cache.get(key)
        if cached is not None:
            self._step, self._timed_raytrace, self._timed_accumulate = cached
            self._timed_warm = False
            self._acc = self._zero_acc()
            return
        bn = None
        if c.blue_noise:
            from ..utils.bluenoise import blue_noise_table

            bn = blue_noise_table(64)
        if self._mesh is not None:
            from ..parallel import make_sharded_frame_step

            self._step = make_sharded_frame_step(
                self._mesh,
                width=c.scaled_width,
                height=c.scaled_height,
                aspect=c.width / c.height,
                samples_per_frame=c.samples_per_frame,
                max_bounces=c.max_bounces,
                accumulate=c.accumulate,
                env_importance=self.env_importance,
                intersector=c.intersector,
                blue_noise=bn,
            )
        else:
            self._step = make_frame_step(
                c.scaled_width,
                c.scaled_height,
                aspect=c.width / c.height,
                samples_per_frame=c.samples_per_frame,
                max_bounces=c.max_bounces,
                accumulate=c.accumulate,
                env_importance=self.env_importance,
                intersector=c.intersector,
                blue_noise=bn,
            )
        # Separately-jitted per-pass programs for enable_timing: the timed
        # path must measure the same compiled artifacts the fused step runs,
        # not an eager re-trace (reference: per-pass timestamp queries,
        # src/timing.ts:56-98).  jax.jit is lazy, so building these is free
        # unless timing is actually used.
        if self._mesh is not None:
            from ..parallel.sharded import make_sharded_passes

            self._timed_raytrace, self._timed_accumulate = make_sharded_passes(
                self._mesh,
                width=c.scaled_width,
                height=c.scaled_height,
                aspect=c.width / c.height,
                samples_per_frame=c.samples_per_frame,
                max_bounces=c.max_bounces,
                accumulate=c.accumulate,
                env_importance=self.env_importance,
                intersector=c.intersector,
                blue_noise=bn,
            )
        else:
            def _raytrace_pass(scene: SceneData, params: RenderParams) -> jax.Array:
                return render_frame(
                    scene,
                    params,
                    width=c.scaled_width,
                    height=c.scaled_height,
                    aspect=c.width / c.height,
                    samples_per_frame=c.samples_per_frame,
                    max_bounces=c.max_bounces,
                    env_importance=self.env_importance,
                    intersector=c.intersector,
                    blue_noise=bn,
                )

            self._timed_raytrace = jax.jit(_raytrace_pass)
            self._timed_accumulate = jax.jit(
                lambda acc, img, frame: accumulate_op(acc, img, frame, enabled=c.accumulate)
            )
        self._timed_warm = False
        self._step_cache[key] = (
            self._step, self._timed_raytrace, self._timed_accumulate
        )
        self._acc = self._zero_acc()

    def _zero_acc(self) -> jax.Array:
        c = self._config
        if self._mesh is not None:
            from ..parallel import zeros_acc

            return zeros_acc(self._mesh, c.scaled_height, c.scaled_width)
        return jnp.zeros((c.scaled_height, c.scaled_width, 3), jnp.float32)

    # convenience setters mirroring the Tweakpane bindings (main.ts:167-349);
    # each resets the progressive render like the reference UI does.
    def set_option(self, **kwargs) -> None:
        import dataclasses

        cfg_fields = {f.name for f in dataclasses.fields(RenderConfig)}
        cfg_updates = {k: v for k, v in kwargs.items() if k in cfg_fields}
        if cfg_updates:
            self.config = dataclasses.replace(self._config, **cfg_updates)
        post_fields = {f.name for f in dataclasses.fields(PostConfig)}
        post_updates = {k: v for k, v in kwargs.items() if k in post_fields}
        if post_updates:
            self.post = dataclasses.replace(self.post, **post_updates)
        rest = set(kwargs) - set(cfg_updates) - set(post_updates)
        for k in rest:
            if k in ("env_intensity", "env_rotation"):
                setattr(self, k, float(kwargs[k]))
                self.reset()
            else:
                raise AttributeError(f"unknown option {k}")

    # ------------------------------------------------------------- events

    def on(self, event: Event, callback: Callable) -> Callable:
        self._listeners.setdefault(event, []).append(callback)
        return lambda: self._listeners[event].remove(callback)

    def emit(self, event: Event, *args) -> None:
        for cb in list(self._listeners.get(event, [])):
            cb(*args)

    # ------------------------------------------------------------- state

    @property
    def frame(self) -> int:
        return self._frame

    @frame.setter
    def frame(self, value: int) -> None:
        self._frame = value
        if self._frame > self._config.frames:
            self.status = "idle"
            self.emit("complete")

    @property
    def progress(self) -> float:
        return self._frame / (self._config.frames + 1)

    @property
    def samples(self) -> int:
        """Accumulated samples per pixel so far ((frame-1) * spp, main.ts:132-138)."""
        return (self._frame - 1) * self._config.samples_per_frame

    def start(self) -> None:
        if self.status != "sampling":
            self.status = "sampling"
            self.emit("start")

    def pause(self) -> None:
        if self.status == "sampling":
            self.status = "paused"
            self.emit("pause")

    def reset(self, *, keep_paused: bool = False) -> None:
        self._acc = self._zero_acc()
        self._frame = 1
        self.emit("reset")
        if not (keep_paused and self.status == "paused"):
            self.status = "sampling"
            self.emit("start")

    # ------------------------------------------------------------- render

    def _compile_scene(self) -> None:
        if self._scene_data is None or self.scene.needs_update:
            self._scene_data = self.scene.compile()

    @property
    def scene_data(self) -> SceneData:
        self._compile_scene()
        return self._scene_data

    def _params(self) -> RenderParams:
        return RenderParams.create(
            self.camera,
            frame=self._frame,
            env_intensity=self.env_intensity,
            env_rotation=self.env_rotation,
        )

    def render(self) -> None:
        """Advance one progressive frame (the reference's per-rAF render(),
        renderer.ts:366-395)."""
        self._compile_scene()
        should_sample = self.status == "sampling" and self._frame <= self._config.frames
        if not should_sample:
            return

        params = self._params()
        if self.enable_timing:
            # Warm up (compile) untimed first so the rolling averages hold
            # steady-state numbers, like the reference's per-pass timestamp
            # queries (src/timing.ts:56-98).
            if not getattr(self, "_timed_warm", False):
                img = self._timed_raytrace(self._scene_data, params)
                jax.block_until_ready(
                    self._timed_accumulate(self._acc, img, params.frame))
                self._timed_warm = True
            # Profiler device busy time on an accelerator (works sharded);
            # wall time + fetch on the CPU (render/timing.PassTimer).
            img = self.timings["raytrace"].time_device(
                self._timed_raytrace, self._scene_data, params
            )
            self._acc = self.timings["accumulate"].time_device(
                self._timed_accumulate, self._acc, img, params.frame
            )
        else:
            self._acc = self._step(self._scene_data, params, self._acc)

        self.frame = self._frame + 1
        self.emit("progress", self.progress)

    def render_all(self, *, checkpoint_path: Optional[str] = None,
                   checkpoint_every: int = 0) -> jax.Array:
        """Run the full progressive budget; returns the raw accumulation.

        With `checkpoint_path` + `checkpoint_every=N`, the accumulation
        state is persisted every N frames — a preempted render resumes at
        the last checkpoint via `load_state` (elastic-recovery analogue,
        SURVEY §5 failure detection; the reference can only pause in-memory).
        """
        if self.status == "idle":
            self.reset()
        if self._mesh is not None and not self.enable_timing:
            # Sharded: run K frames per dispatch inside one jitted
            # fori_loop, so per-frame host dispatch across the mesh does
            # not land between frames.  Progress events and checkpoints
            # fire per chunk.
            self._compile_scene()
            while self.status == "sampling" and self._frame <= self._config.frames:
                remaining = self._config.frames - self._frame + 1
                k = min(remaining, checkpoint_every or 32)
                self._acc = self._chunk_step(k)(
                    self._scene_data, self._params(), self._acc
                )
                self.frame = self._frame + k
                self.emit("progress", self.progress)
                if checkpoint_path and checkpoint_every:
                    self.save_state(checkpoint_path)
            if checkpoint_path and checkpoint_every:
                self.save_state(checkpoint_path)
            return self.accumulation
        while self.status == "sampling" and self._frame <= self._config.frames:
            self.render()
            if (checkpoint_path and checkpoint_every
                    and (self._frame - 1) % checkpoint_every == 0):
                self.save_state(checkpoint_path)
        if checkpoint_path and checkpoint_every:
            self.save_state(checkpoint_path)
        return self.accumulation

    def _chunk_step(self, k: int):
        """Jitted K-frame advance (scene, params0, acc) -> acc for the
        sharded whole-budget path; memoized per (step, k)."""
        import dataclasses

        cache = getattr(self, "_chunk_cache", None)
        if cache is None:
            cache = self._chunk_cache = {}
        key = (id(self._step), k)
        if key not in cache:
            step = self._step

            def run(scene, params0, acc, _k=k, _step=step):
                def body(f, acc):
                    p = dataclasses.replace(
                        params0,
                        frame=params0.frame + f.astype(jnp.uint32),
                    )
                    return _step(scene, p, acc)

                return jax.lax.fori_loop(0, _k, body, acc)

            cache[key] = jax.jit(run)
        return cache[key]

    # ------------------------------------------------------------- output

    @property
    def accumulation(self) -> jax.Array:
        """Raw accumulated radiance at render resolution (h, w, 3)."""
        return self._acc

    def display(self) -> jax.Array:
        """Post-processed display image at full resolution (the fullscreen
        pass: denoise -> upscale -> tonemap)."""
        c = self._config

        def run():
            return _jit_postprocess(self._acc, self.post, c.height, c.width)

        if self.enable_timing:
            return self.timings["fullscreen"].time_device(run)
        return run()

    def set_env_importance(self, enabled: bool) -> None:
        """Toggle env CDF importance sampling; rebuilds the jitted step
        (the public API the viewer uses instead of poking _rebuild)."""
        enabled = bool(enabled)
        if enabled != self.env_importance:
            self.env_importance = enabled
            self._rebuild()

    def set_timing(self, enabled: bool) -> None:
        """Toggle per-pass timing; works sharded too since round 3 (timed
        passes are profiler device spans, render/timing.time_device)."""
        self.enable_timing = bool(enabled)

    def screenshot(self, path: str) -> None:
        """Save the display image as PNG (reference: canvas.toDataURL,
        src/main.ts:351-356)."""
        from ..io.image import write_png

        img = np.asarray(self.display())
        write_png(path, img, flip_vertical=True)

    # ------------------------------------------------------------- resume

    def save_state(self, path: str) -> None:
        """Checkpoint the progressive render (accumulation + frame counter).

        The reference only pauses in-memory (SURVEY §5 checkpoint/resume);
        on-disk resume is a net-new capability.
        """
        np.savez(path, acc=np.asarray(self._acc), frame=self._frame,
                 frames=self._config.frames, spp=self._config.samples_per_frame)

    def load_state(self, path: str) -> None:
        data = np.load(path)
        self._acc = jnp.asarray(data["acc"])
        if self._mesh is not None:
            from ..parallel import acc_sharding

            self._acc = jax.device_put(self._acc, acc_sharding(self._mesh))
        self._frame = int(data["frame"])
        self.status = "sampling" if self._frame <= self._config.frames else "idle"
