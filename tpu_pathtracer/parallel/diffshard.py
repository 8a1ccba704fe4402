"""Sharded differentiable rendering: data-parallel gradients over the mesh.

The inverse-rendering north star (BASELINE.json: "all-reducing parameter
gradients overlapped with the backward pass"): the image loss shards by row
bands over the 'tiles' axis, each shard runs the differentiable trace +
backward on its band, and per-shard gradients are all-reduced (the psum
reverse-mode inserts for axis-invariant inputs) — XLA's latency-hiding
scheduler is responsible for overlapping that collective with the
remaining backward computation.  The overlap is not measured: it is a
property delegated to XLA until a four-card trace shows it.

Exactness: the sharded loss/grad equals the unsharded one (global pixel
coordinates + seeds per shard; sums decompose exactly over row bands), so
optimizers behave identically at any mesh size.
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

from ..diff import api as diff_api
from ..ops.trace import render_frame
from .mesh import AXIS_TILES


def target_sharding(mesh) -> NamedSharding:
    return NamedSharding(mesh, P(AXIS_TILES, None, None))


def make_sharded_value_and_grad(
    mesh,
    scene,
    params,
    *,
    width: int,
    height: int,
    aspect: float,
    samples_per_frame: int = 1,
    max_bounces: int = 2,
):
    """Build f(values, target) -> (loss, grads) where the render + backward
    shard by row bands and gradients psum over the 'tiles' axis.

    `values` is a flat {path: array} dict (diff.api.extract) — its keys
    alone determine which leaves are differentiated; `target` is the full
    (H, W, 3) image, sharded per `target_sharding(mesh)` (a replicated
    array works too — shard_map slices it).
    Loss = 0.5 * mean((img - target)^2), matching diff.api.l2_image_loss.
    """
    from .mesh import shard_map_compat_kwargs

    n_tiles = mesh.shape[AXIS_TILES]
    if height % n_tiles != 0:
        raise ValueError(f"height {height} must divide by tile axis {n_tiles}")
    rows = height // n_tiles
    denom = jnp.float32(width * height * 3)
    _kwargs = shard_map_compat_kwargs(shard_map)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(AXIS_TILES, None, None)),
        out_specs=(P(), P()),
        **_kwargs,
    )
    def f(values, target_shard):
        ti = jax.lax.axis_index(AXIS_TILES)

        def local_loss(values):
            s, p = diff_api.insert(scene, params, values)
            img = render_frame(
                s, p, width=width, height=rows, aspect=aspect,
                samples_per_frame=samples_per_frame, max_bounces=max_bounces,
                differentiable=True, row_offset=ti * rows, full_height=height,
            )
            return 0.5 * jnp.sum((img - target_shard) ** 2) / denom

        loss, grads = jax.value_and_grad(local_loss)(values)
        loss = jax.lax.psum(loss, AXIS_TILES)
        # No manual psum on grads: `values` is axis-INVARIANT (in_spec P()),
        # so reverse-mode's transpose of the implicit invariant->varying
        # broadcast already all-reduces the cotangents across the mesh
        # (shard_map vma semantics).  A manual psum would multiply the
        # gradients by the shard count (caught by
        # tests/test_parallel.py::test_sharded_grads_match_unsharded when
        # check_vma went from disabled to on).  The all-reduce is still
        # scheduled by XLA against the remaining backward work.
        return loss, grads

    return jax.jit(f)


def invert_sharded(
    mesh,
    scene,
    params,
    target,
    paths,
    *,
    width: int,
    height: int,
    aspect: float,
    samples_per_frame: int = 1,
    max_bounces: int = 2,
    steps: int = 100,
    learning_rate: float = 5e-2,
):
    """diff.invert with the render + backward sharded over the mesh."""
    import optax

    from ..diff.invert import InvertResult

    vg = make_sharded_value_and_grad(
        mesh, scene, params, width=width, height=height, aspect=aspect,
        samples_per_frame=samples_per_frame, max_bounces=max_bounces,
    )
    target = jax.device_put(target, target_sharding(mesh))
    values = diff_api.extract(scene, params, paths)
    opt = optax.adam(learning_rate)
    opt_state = opt.init(values)

    @jax.jit
    def step(values, opt_state):
        l, g = vg(values, target)
        updates, opt_state = opt.update(g, opt_state, values)
        return optax.apply_updates(values, updates), opt_state, l

    losses = []
    for _ in range(steps):
        values, opt_state, l = step(values, opt_state)
        losses.append(float(l))
    return InvertResult(values=values, losses=losses)
