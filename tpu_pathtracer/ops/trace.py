"""The path-trace loop and whole-frame rendering (XLA megakernel path).

Faithful re-expression of the reference's single compute kernel
(reference: src/passes/shaders/raytrace.wgsl:373-478) as vectorized JAX over a
flat ray axis:

  * bounce loop: intersect -> sample BRDF -> accumulate emission -> continue,
    miss -> add environment radiance and terminate (raytrace.wgsl:378-408),
  * diffuse direction = cosine-weighted hemisphere, specular = mirror
    reflection, chosen per-ray with probability = metalness, blended by
    `isSpecular * (1 - roughness)` without renormalization
    (raytrace.wgsl:383-391),
  * throughput *= mix(color, specularColor, isSpecular) (raytrace.wgsl:395),
  * per-pixel seed and per-sample DoF/AA jitters (raytrace.wgsl:424-455).

Divergence is handled with lane masks: rays that missed stay inactive for the
remaining bounces, and RNG state only advances for rays that consumed samples,
keeping the integer RNG stream identical to the reference's per-thread stream.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import INTERSECTORS
from . import camera as camera_ops
from . import envsample, rng
from .intersect import (
    bvh_fat_intersect,
    bvh_intersect,
    bvh_intersect_diff,
    replay_hit,
)
from .mt_matmul import mt_intersect
from .pallas.mt_triton import mt_intersect_triton
from .vecmath import mix, normalize, reflect

# Scenes at or below this padded triangle count take the all-pairs
# Möller–Trumbore intersector; larger ones the fat-leaf BVH walk ('bvh8'),
# whose cost grows with depth instead of triangle count.  At 8,192 the
# fused kernel still wins on an H100 (700 W): 30.6 ms against 74.9 ms for
# bvh8 per 512^2 x 4-bounce frame (PERF.md); larger counts are not
# measured yet.
MT_AUTO_MAX_TRIS = 8192


def resolve_intersector(intersector: str, n_tris: int,
                        backend: str | None = None) -> str:
    """Resolve an intersector name to a concrete one for `backend`
    (default: jax.default_backend()).

    'auto' takes the all-pairs Möller–Trumbore path up to
    MT_AUTO_MAX_TRIS padded triangles, then the fat-leaf traversal
    ('bvh8'): on the GPU the fused kernel ('mt_pallas',
    ops/pallas/mt_triton.py), elsewhere the plain XLA form ('mt', the same
    math).  'mt_pallas' is a compiled GPU kernel, so asking for it on
    another backend is an error, never a silent interpreter run.  'bvh' is
    the reference-contract 1-triangle-leaf skip-link walk."""
    if intersector not in INTERSECTORS:
        raise ValueError(f"unknown intersector {intersector!r}")
    backend = backend or jax.default_backend()
    if intersector == "auto":
        if n_tris > MT_AUTO_MAX_TRIS:
            return "bvh8"
        return "mt_pallas" if backend == "gpu" else "mt"
    if intersector == "mt_pallas" and backend != "gpu":
        raise ValueError(
            f"intersector 'mt_pallas' is a GPU kernel and the backend is "
            f"{backend!r}; use 'auto' or 'mt'")
    return intersector


# All-pairs intersectors by name.  Tests on the CPU swap an entry for the
# kernel in interpret mode to run it through the whole trace loop.
MT_FNS = {"mt": mt_intersect, "mt_pallas": mt_intersect_triton}


def pack_material_rows(materials):
    """Pack the material SoA into one gather-friendly (M, 12) row table:
    [color(3), specular_color(3), emission_color(3), roughness, metalness,
    emission_strength].  One wide gather per bounce replaces six narrow ones
    (same packed-row treatment the geometry got, scene/types.py); built from
    the SoA fields inside the jitted step so material gradients still flow
    (concatenate is linear), and hoisted out of the bounce loop by XLA."""
    return jnp.concatenate(
        [
            materials.color,
            materials.specular_color,
            materials.emission_color,
            materials.roughness[:, None],
            materials.metalness[:, None],
            materials.emission_strength[:, None],
        ],
        axis=1,
    )


def _gather_material(materials, idx, mat_rows=None):
    safe = jnp.clip(idx, 0, materials.roughness.shape[0] - 1)
    if mat_rows is None:
        mat_rows = pack_material_rows(materials)
    row = mat_rows[safe]  # (R, 12) single gather
    return {
        "color": row[:, 0:3],
        "specular_color": row[:, 3:6],
        "emission_color": row[:, 6:9],
        "roughness": row[:, 9],
        "metalness": row[:, 10],
        "emission_strength": row[:, 11],
    }


def trace_rays(scene, params, ro, rd, seed, *, max_bounces: int,
               env_importance: bool = False, differentiable: bool = False,
               intersector: str = "auto"):
    """Trace a batch of rays to completion.

    ro, rd: (R, 3); seed: (R,) uint32.
    Returns (incoming_light (R, 3), seed).

    `intersector` selects the intersection backend (static):
    'mt'/'mt_pallas' = all-pairs Möller–Trumbore (plain XLA / fused GPU
    kernel), 'bvh' = 1-tri-leaf skip-link traversal, 'bvh8' = fat-leaf
    sub-batched traversal, 'auto' = by scene size and backend
    (`resolve_intersector`).  All are parity-tested against each other and
    the numpy oracle; they differ only by f32 re-association and the
    tie-break on exact shared-edge t ties.

    With `differentiable=True` the discrete triangle choice runs detached
    and (t, u, v) are replayed analytically (intersect.replay_hit), making
    the whole trace reverse-differentiable w.r.t. materials, environment
    radiance, camera, and vertex data (the fori_loop bodies are
    scan-convertible).
    """
    R = ro.shape[0]
    tri_pos = scene.packed.tri_pos
    kind = resolve_intersector(intersector, tri_pos.shape[0])
    if kind in MT_FNS or kind == "bvh8":
        if kind == "bvh8":
            fat = jax.lax.stop_gradient(scene.packed.fat_nodes)
            base_fn = lambda _tri_pos, ro, rd: bvh_fat_intersect(fat, ro, rd)
        else:
            base_fn = MT_FNS[kind]
        if differentiable:
            def intersect_fn(ro, rd):
                h = base_fn(
                    jax.lax.stop_gradient(tri_pos),
                    jax.lax.stop_gradient(ro),
                    jax.lax.stop_gradient(rd),
                )
                return replay_hit(tri_pos, ro, rd, h)
        else:
            intersect_fn = lambda ro, rd: base_fn(tri_pos, ro, rd)
    else:
        fn = bvh_intersect_diff if differentiable else bvh_intersect
        intersect_fn = partial(fn, scene.packed.nodes, tri_pos)

    # Pre-packed wide-row tables (one gather per bounce each; hoisted out of
    # the bounce loop by XLA, differentiable w.r.t. materials/env radiance).
    shade_mat = pack_shade_material_rows(scene)
    env_patches = envsample.pack_env_patches(scene.env.radiance)

    # A zero that carries `seed`'s value-varying-axes type: literal loop-
    # carry inits must match the body's vma type under shard_map's checker
    # (check_vma=True), and seed is axis-varying whenever the surrounding
    # shard_fn varies it (row offset / sample salt).  Numerically a no-op,
    # fused away by XLA.
    vz = (seed ^ seed).astype(jnp.uint32)
    zf = vz.astype(jnp.float32)[:, None]

    def body(_, carry):
        ro, rd, incoming, color, seed, active = carry
        # Park terminated rays far away with rd = 0: their determinant is
        # identically 0 (a guaranteed miss, no inf/nan) and the BVH walks
        # miss the root box at once.  bounce_shade gates every state update
        # on `active`, so the parked values never propagate.
        am = active[:, None]
        hit = intersect_fn(
            jnp.where(am, ro, jnp.float32(1e30)),
            jnp.where(am, rd, jnp.float32(0.0)),
        )
        return bounce_shade(
            scene, params, hit, (ro, rd, incoming, color, seed, active),
            env_importance=env_importance, shade_mat=shade_mat,
            env_patches=env_patches,
        )

    init = (
        ro,
        rd,
        jnp.zeros((R, 3), jnp.float32) + zf,
        jnp.ones((R, 3), jnp.float32) + zf,
        seed,
        jnp.ones((R,), bool) ^ (vz != 0),
    )
    if differentiable:
        # while_loop has no reverse-mode rule; the fixed-trip fori_loop is
        # scan-convertible for backprop.
        _, _, incoming, _, seed, _ = jax.lax.fori_loop(0, max_bounces, body, init)
    else:
        # Early exit once every ray has terminated (bit-identical: the body
        # is an identity when no lane is active, because every state update
        # is gated on hit/miss masks that require `active`).  The reference
        # always runs maxBounces iterations (raytrace.wgsl:378); on
        # miss-heavy scenes this skips whole intersection rounds.  On the
        # GPU, XLA reads the data-dependent predicate back to the host
        # once per bounce (PERF.md).
        def w_cond(state):
            i, carry = state
            return (i < max_bounces) & jnp.any(carry[5])

        def w_body(state):
            i, carry = state
            return i + 1, body(i, carry)

        _, (_, _, incoming, _, seed, _) = jax.lax.while_loop(
            w_cond, w_body, (jnp.int32(0), init)
        )
    return incoming, seed


def pack_shade_material_rows(scene):
    """Join the per-triangle shading row with its material row:
    (N, 21) = [n0(3), n1(3), n2(3), material row(12)].  ONE gather per
    bounce then yields normals AND material values together (the material
    row join is itself one (N,)-index gather, hoisted out of the bounce
    loop by XLA; gradients flow through pack_material_rows' concat)."""
    mat_rows = pack_material_rows(scene.materials)
    mat_idx = jax.lax.bitcast_convert_type(
        scene.packed.tri_shade[:, 9], jnp.int32
    )
    tri_mat = mat_rows[jnp.clip(mat_idx, 0, mat_rows.shape[0] - 1)]
    return jnp.concatenate([scene.packed.tri_shade[:, 0:9], tri_mat], axis=1)


def _material_from_row(row):
    return {
        "color": row[:, 9:12],
        "specular_color": row[:, 12:15],
        "emission_color": row[:, 15:18],
        "roughness": row[:, 18],
        "metalness": row[:, 19],
        "emission_strength": row[:, 20],
    }


def bounce_shade(scene, params, hit, carry, *, env_importance: bool = False,
                 mat_rows=None, shade_mat=None, env_patches=None):
    """One bounce of the trace loop given a Hit: BRDF sample + emission +
    throughput update on hits, environment lookup on misses
    (raytrace.wgsl:378-408).  Shared by the megakernel (`trace_rays`) and
    the wavefront tracer (ops/wavefront.py).

    Optional pre-packed tables (all built per trace, hoisted out of the
    bounce loop; each replaces several narrow gathers with one wide row
    gather — the measured gather cost is per-index, width-free):
      * `shade_mat`: (N, 21) joined normals+material rows
        (pack_shade_material_rows); else `mat_rows`/per-field fallback,
      * `env_patches`: (H*W, 12) bilinear patch rows
        (envsample.pack_env_patches)."""
    ro, rd, incoming, color, seed, active = carry
    tris = scene.triangles
    hit_mask = active & hit.hit

    tri_safe = jnp.clip(hit.tri, 0, tris.p0.shape[0] - 1)
    if shade_mat is not None:
        shade = shade_mat[tri_safe]  # (R, 21) single gather
        mat = _material_from_row(shade)
    else:
        shade = scene.packed.tri_shade[tri_safe]  # (R, 10) single gather
        mat_idx = jax.lax.bitcast_convert_type(shade[:, 9], jnp.int32)
        mat = _gather_material(scene.materials, mat_idx, mat_rows)
    w = 1.0 - hit.u - hit.v
    normal = normalize(
        shade[:, 0:3] * w[:, None]
        + shade[:, 3:6] * hit.u[:, None]
        + shade[:, 6:9] * hit.v[:, None]
    )
    position = ro + hit.t[:, None] * rd

    # RNG: hit rays consume 7 uniforms (6 for the cosine direction, 1 for
    # the specular decision); missed/inactive rays must not advance.
    seed_h, diffuse_dir = rng.rand_cosine_hemisphere(seed, normal)
    seed_h, r_spec = rng.rand(seed_h)
    is_specular = (mat["metalness"] >= r_spec).astype(jnp.float32)
    specular_dir = reflect(rd, normal)
    blend = (is_specular * (1.0 - mat["roughness"]))[:, None]
    new_dir = mix(diffuse_dir, specular_dir, blend)  # deliberately unnormalized

    # --- miss branch: environment lookup -----------------------------
    emitted = mat["emission_color"] * mat["emission_strength"][:, None]
    incoming = incoming + jnp.where(hit_mask[:, None], emitted * color, 0.0)

    miss_mask = active & ~hit.hit

    def _radiance(uv):
        if env_patches is not None:
            shape = (scene.env.height, scene.env.width)
            return envsample.env_radiance_packed(env_patches, shape, uv)
        return envsample.env_radiance(scene.env, uv)

    if env_importance:
        # The reference's (shipped-disabled) importance-sampled variant,
        # with the PDF correction applied to the env term only
        # (raytrace.wgsl:398-404).  Consumes 2 uniforms on miss.
        seed_m, env_uv = envsample.env_importance_sample(scene.env, seed)
        pdf = envsample.env_pdf(scene.env, env_uv)
        env_contrib = _radiance(env_uv) * params.env_intensity / pdf[:, None]
        seed = jnp.where(miss_mask, seed_m, seed)
    else:
        env_uv = envsample.env_uv_from_ray(rd, params.env_rotation)
        env_contrib = _radiance(env_uv) * params.env_intensity
    incoming = incoming + jnp.where(
        miss_mask[:, None], env_contrib * color, 0.0
    )

    color = jnp.where(
        hit_mask[:, None],
        color * mix(mat["color"], mat["specular_color"], is_specular[:, None]),
        color,
    )
    ro = jnp.where(hit_mask[:, None], position, ro)
    rd = jnp.where(hit_mask[:, None], new_dir, rd)
    seed = jnp.where(hit_mask, seed_h, seed)
    active = hit_mask

    return ro, rd, incoming, color, seed, active


def render_frame(
    scene,
    params,
    *,
    width: int,
    height: int,
    aspect: float,
    samples_per_frame: int = 1,
    max_bounces: int = 4,
    env_importance: bool = False,
    differentiable: bool = False,
    intersector: str = "auto",
    blue_noise=None,
    row_offset=0,
    full_height: int | None = None,
    seed_salt=None,
):
    """Render one progressive frame at (height, width); returns (H, W, 3) f32.

    Row 0 corresponds to uv.y = 0 (the *bottom* of the camera frustum, because
    v = -t + 2t*uv.y, raytrace.wgsl:223); image writers flip to display
    orientation.  `aspect` is the display aspect (renderer.ts aspect getter),
    which can differ from width/height under resolution scaling.

    Sharding hooks (used by parallel.sharded inside shard_map):
      * `row_offset` / `full_height`: this call renders rows
        [row_offset, row_offset + height) of a `full_height`-tall image; pixel
        seeds and uv.y are computed in *global* coordinates, so a row-sharded
        render is bit-identical to the unsharded one.
      * `seed_salt`: optional u32 folded into the per-pixel seed to decorrelate
        sample-axis shards (salt 0 == the reference's exact stream).

    `blue_noise`: optional (Hb, Wb, 2) toroidal rank table
    (utils.bluenoise.blue_noise_table).  When given, the AA pixel jitter
    uses a Cranley–Patterson-rotated R2 low-discrepancy sequence — point n
    (n = global sample number) offset per pixel by the blue-noise ranks —
    instead of the PCG hash draws.  This is the reference's intended-but-
    dead blue-noise asset made live (src/assets/noise.ts, loader commented
    at src/renderer.ts:562-588): pixel-to-pixel AA error becomes
    high-frequency ("blue"), lowering the visible low-frequency error at
    small sample counts (tests/test_bluenoise_sampling.py measures it).
    Everything else keeps the per-pixel PCG streams (the stream skips the
    two AA draws; this mode is not bit-compatible with the reference).
    """
    if full_height is None:
        full_height = height
    R = width * height
    xs = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1)
    ys = jax.lax.broadcasted_iota(
        jnp.int32, (height, width), 0
    ) + jnp.asarray(row_offset, jnp.int32)
    uv = jnp.stack(
        [
            xs.astype(jnp.float32) / np.float32(width),
            ys.astype(jnp.float32) / np.float32(full_height),
        ],
        axis=-1,
    ).reshape(R, 2)
    pixel_index = (xs + ys * width).reshape(R)
    seed = rng.pixel_seed(pixel_index, params.frame)
    if seed_salt is not None:
        seed = seed + jnp.asarray(seed_salt).astype(jnp.uint32)

    base_o, base_d = camera_ops.camera_rays(params.camera, uv, jnp.float32(aspect))
    # AA jitter scales by the FULL render resolution (uniforms.resolution,
    # raytrace.wgsl:444), not the local row-band height.
    resolution = jnp.array([width, full_height], jnp.float32)

    if blue_noise is not None:
        bn = jnp.asarray(blue_noise, jnp.float32)
        hb, wb = bn.shape[0], bn.shape[1]
        bn_pix = bn[ys % hb, xs % wb].reshape(R, 2)  # per-pixel CP offsets
        # R2 quasi-random sequence (Roberts): the same point for every pixel
        # at a given global sample number; the per-pixel rotation carries all
        # the spatial structure.
        r2a = np.float32(0.7548776662466927)
        r2b = np.float32(0.5698402909980532)

    # taint the accumulator init with seed's vma type (see trace_rays)
    zf0 = (seed ^ seed).astype(jnp.float32)[:, None]

    def sample_body(s, carry):
        seed, acc = carry
        if blue_noise is not None:
            n = (params.frame.astype(jnp.float32) - 1.0) * np.float32(
                samples_per_frame
            ) + s.astype(jnp.float32)
            base = jnp.stack([jnp.mod(n * r2a, 1.0), jnp.mod(n * r2b, 1.0)])
            aa = jnp.mod(base[None, :] + bn_pix, 1.0)
        else:
            aa = None
        seed, o, d = camera_ops.apply_dof(
            seed, base_o, base_d, params.camera, resolution, aa_uniforms=aa
        )
        light, seed = trace_rays(
            scene, params, o, d, seed, max_bounces=max_bounces,
            env_importance=env_importance, differentiable=differentiable,
            intersector=intersector,
        )
        return seed, acc + light

    _, acc = jax.lax.fori_loop(
        0, samples_per_frame, sample_body,
        (seed, jnp.zeros((R, 3), jnp.float32) + zf0),
    )
    color = acc / np.float32(samples_per_frame)
    return color.reshape(height, width, 3)


def accumulate(prev, current, frame, enabled: bool = True):
    """Progressive running mean (reference: src/passes/shaders/accumulate.wgsl:21-28).

    weight = 1/frame (frame is 1-based), so frame 1 replaces, frame k blends.
    """
    f = jnp.asarray(frame).astype(jnp.float32)
    weight = jnp.where(f > 0, 1.0 / jnp.maximum(f, 1.0), 1.0)
    if not enabled:
        weight = jnp.float32(1.0)
    return prev + (current - prev) * weight
