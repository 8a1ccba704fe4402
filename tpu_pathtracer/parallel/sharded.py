"""Sharded progressive rendering via shard_map over the ('tiles','samples') mesh.

The replacement for the reference's single compute queue
(SURVEY.md §2 'Parallelism & communication'): the pixel grid shards by row
bands over the ``tiles`` axis and the per-frame sample budget shards over the
``samples`` axis.  Per-shard partial radiance is combined with a ``psum`` over
``samples`` (an all-reduce); the row-sharded accumulation buffer stays
resident and sharded across frames, and materializes as one global array only
when the host reads it (XLA inserts the all-gather).

Exactness contract:
  * tile sharding is bit-identical to the unsharded render — pixel seeds and
    uv are computed in global coordinates (ops/trace.render_frame row_offset),
  * sample sharding keeps shard 0 on the reference's exact RNG stream and
    decorrelates shards 1..S-1 with a Weyl-increment seed salt; the result is
    an equally-valid Monte-Carlo estimate with the same per-frame sample count
    (statistically identical, not bit-identical, to sequential spp).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from ..ops.trace import accumulate as accumulate_op
from ..ops.trace import render_frame
from .mesh import AXIS_SAMPLES, AXIS_TILES

# Weyl sequence increment (2^32 / golden ratio, odd) — decorrelates the
# sample-axis RNG streams without touching shard 0's reference stream.
_SALT = 0x9E3779B9


def acc_sharding(mesh) -> NamedSharding:
    """Sharding of the (H, W, 3) accumulation buffer: rows over 'tiles',
    replicated over 'samples'."""
    return NamedSharding(mesh, P(AXIS_TILES, None, None))


def zeros_acc(mesh, height: int, width: int) -> jax.Array:
    return jax.device_put(
        jnp.zeros((height, width, 3), jnp.float32), acc_sharding(mesh)
    )


def make_sharded_frame_step(
    mesh,
    *,
    width: int,
    height: int,
    aspect: float,
    samples_per_frame: int = 1,
    max_bounces: int = 4,
    accumulate: bool = True,
    env_importance: bool = False,
    intersector: str = "auto",
    blue_noise=None,
):
    """Build the jitted sharded progressive step.

    Returns step(scene, params, acc) -> acc' where acc is (H, W, 3) sharded
    per `acc_sharding(mesh)`; scene/params are replicated.
    """
    n_tiles = mesh.shape[AXIS_TILES]
    n_samples = mesh.shape[AXIS_SAMPLES]
    if height % n_tiles != 0:
        raise ValueError(f"height {height} must divide by tile axis {n_tiles}")
    if samples_per_frame % n_samples != 0:
        raise ValueError(
            f"samples_per_frame {samples_per_frame} must divide by sample axis {n_samples}"
        )
    rows = height // n_tiles
    spp_local = samples_per_frame // n_samples

    from .mesh import shard_map_compat_kwargs

    _smap = partial(shard_map, mesh=mesh, **shard_map_compat_kwargs(shard_map))

    @partial(
        _smap,
        in_specs=(P(), P(), P(AXIS_TILES, None, None)),
        out_specs=P(AXIS_TILES, None, None),
    )
    def shard_fn(scene, params, acc_shard):
        ti = jax.lax.axis_index(AXIS_TILES)
        # Sample-axis salt only when that axis is real: at n_samples == 1 the
        # salt is identically 0 anyway, but deriving it from axis_index would
        # type the output as samples-VARYING with no psum to discharge it,
        # which the vma checker rightly rejects against the tiles-only
        # out_spec.
        if n_samples > 1:
            si = jax.lax.axis_index(AXIS_SAMPLES)
            salt = si.astype(jnp.uint32) * jnp.uint32(_SALT)
        else:
            salt = None
        img = render_frame(
            scene,
            params,
            width=width,
            height=rows,
            aspect=aspect,
            samples_per_frame=spp_local,
            max_bounces=max_bounces,
            env_importance=env_importance,
            intersector=intersector,
            blue_noise=blue_noise,
            row_offset=ti * rows,
            full_height=height,
            seed_salt=salt,
        )
        # Mean over the sample axis: each shard holds the mean of its
        # spp_local samples, so the cross-shard mean is psum / n_samples.
        if n_samples > 1:
            img = jax.lax.psum(img, AXIS_SAMPLES) / jnp.float32(n_samples)
        return accumulate_op(acc_shard, img, params.frame, enabled=accumulate)

    return jax.jit(shard_fn, donate_argnums=(2,))


def make_sharded_passes(
    mesh,
    *,
    width: int,
    height: int,
    aspect: float,
    samples_per_frame: int = 1,
    max_bounces: int = 4,
    accumulate: bool = True,
    env_importance: bool = False,
    intersector: str = "auto",
    blue_noise=None,
):
    """Separately-jitted (raytrace, accumulate) sharded passes for per-pass
    timing: `enable_timing` on a sharded Renderer
    measures these with profiler device spans (render/timing.time_device),
    while the untimed path keeps the fused `make_sharded_frame_step`.

    raytrace(scene, params) -> (H, W, 3) row-sharded frame;
    acc(acc, img, frame) -> acc' (elementwise; XLA propagates sharding).
    """
    n_tiles = mesh.shape[AXIS_TILES]
    n_samples = mesh.shape[AXIS_SAMPLES]
    if height % n_tiles != 0:
        raise ValueError(f"height {height} must divide by tile axis {n_tiles}")
    if samples_per_frame % n_samples != 0:
        raise ValueError(
            f"samples_per_frame {samples_per_frame} must divide by sample "
            f"axis {n_samples}"
        )
    rows = height // n_tiles
    spp_local = samples_per_frame // n_samples

    from .mesh import shard_map_compat_kwargs

    _smap = partial(shard_map, mesh=mesh, **shard_map_compat_kwargs(shard_map))

    @partial(_smap, in_specs=(P(), P()), out_specs=P(AXIS_TILES, None, None))
    def raytrace_fn(scene, params):
        ti = jax.lax.axis_index(AXIS_TILES)
        if n_samples > 1:
            si = jax.lax.axis_index(AXIS_SAMPLES)
            salt = si.astype(jnp.uint32) * jnp.uint32(_SALT)
        else:
            salt = None
        img = render_frame(
            scene, params, width=width, height=rows, aspect=aspect,
            samples_per_frame=spp_local, max_bounces=max_bounces,
            env_importance=env_importance, intersector=intersector,
            blue_noise=blue_noise, row_offset=ti * rows, full_height=height,
            seed_salt=salt,
        )
        if n_samples > 1:
            img = jax.lax.psum(img, AXIS_SAMPLES) / jnp.float32(n_samples)
        return img

    acc_fn = jax.jit(
        lambda acc, img, frame: accumulate_op(acc, img, frame, enabled=accumulate)
    )
    return jax.jit(raytrace_fn), acc_fn


def make_sharded_render_all(
    mesh,
    *,
    width: int,
    height: int,
    aspect: float,
    frames: int = 64,
    samples_per_frame: int = 1,
    max_bounces: int = 4,
    accumulate: bool = True,
    env_importance: bool = False,
    intersector: str = "auto",
    blue_noise=None,
):
    """Whole progressive render as ONE jitted lax.fori_loop over frames —
    the multi-chip batch path (no host round-trip per frame).

    ``render_all(scene, params0, n_frames=frames)``: the frame count is a
    TRACED dynamic loop bound, so one compiled program serves every frame
    count."""
    step = make_sharded_frame_step(
        mesh,
        width=width,
        height=height,
        aspect=aspect,
        samples_per_frame=samples_per_frame,
        max_bounces=max_bounces,
        accumulate=accumulate,
        env_importance=env_importance,
        intersector=intersector,
        blue_noise=blue_noise,
    )
    sharding = acc_sharding(mesh)

    @jax.jit
    def render_n(scene, params0, n_frames):
        import dataclasses

        acc = jax.lax.with_sharding_constraint(
            jnp.zeros((height, width, 3), jnp.float32), sharding
        )

        def body(f, acc):
            p = dataclasses.replace(params0, frame=(f + 1).astype(jnp.uint32))
            return step(scene, p, acc)

        return jax.lax.fori_loop(
            0, jnp.asarray(n_frames, jnp.int32), body, acc
        )

    def render_all(scene, params0, n_frames=None):
        return render_n(scene, params0, frames if n_frames is None else n_frames)

    return render_all
