"""Device-side scene representation: flat struct-of-arrays pytrees.

The reference marshals array-of-struct GPU buffers whose layouts are derived
from the WGSL struct declarations (Triangle / Material / BVHNode,
reference: src/passes/shaders/raytrace.wgsl:31-64, packed by webgpu-utils in
src/passes/raytrace.ts:89-167).  Vectorized XLA wants the transpose:
plain struct-of-arrays with static shapes so every field is a dense
vector.  All arrays here are padded to fixed sizes so recompilation only
happens when the padded capacity changes, not per scene edit.

Padding conventions:
  * triangles: degenerate all-zero triangles never intersect (Möller–Trumbore
    determinant == 0 -> miss), so padding is inert.
  * BVH nodes: padded nodes have left = right = -1, is_leaf = 0, and an
    inverted AABB (min=+inf, max=-inf) which fails every slab test.
  * materials: padded entries are black.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


def _register(cls=None, *, data: tuple[str, ...] = (), meta: tuple[str, ...] = ()):
    def wrap(c):
        c = dataclasses.dataclass(c)
        jax.tree_util.register_dataclass(c, data_fields=list(data), meta_fields=list(meta))
        return c

    return wrap(cls) if cls is not None else wrap


@_register(
    data=("p0", "p1", "p2", "n0", "n1", "n2", "material"),
    meta=(),
)
class Triangles:
    """World-space triangle soup (reference Triangle struct, raytrace.wgsl:40-49;
    world-space transform applied at scene-compile time exactly like
    src/passes/raytrace.ts:425-502)."""

    p0: jax.Array  # (N, 3) f32 vertex positions
    p1: jax.Array
    p2: jax.Array
    n0: jax.Array  # (N, 3) f32 vertex normals (world space, normalized)
    n1: jax.Array
    n2: jax.Array
    material: jax.Array  # (N,) i32 material index

    @property
    def count(self) -> int:
        return self.p0.shape[0]


@_register(
    data=(
        "color",
        "specular_color",
        "roughness",
        "metalness",
        "emission_color",
        "emission_strength",
    )
)
class Materials:
    """Material table (reference Material struct, raytrace.wgsl:31-38)."""

    color: jax.Array  # (M, 3)
    specular_color: jax.Array  # (M, 3)
    roughness: jax.Array  # (M,)
    metalness: jax.Array  # (M,)
    emission_color: jax.Array  # (M, 3)
    emission_strength: jax.Array  # (M,)

    @property
    def count(self) -> int:
        return self.roughness.shape[0]


@_register(data=("node_min", "node_max", "left", "right", "tri", "is_leaf"))
class FlatBVH:
    """Flattened BVH, breadth-first order, root at index 0, one triangle per
    leaf (the layout contract of the reference flattener,
    src/passes/raytrace.ts:667-694; node fields raytrace.wgsl:51-64)."""

    node_min: jax.Array  # (K, 3)
    node_max: jax.Array  # (K, 3)
    left: jax.Array  # (K,) i32, -1 for leaves/padding
    right: jax.Array  # (K,) i32
    tri: jax.Array  # (K,) i32 triangle index, -1 for internal/padding
    is_leaf: jax.Array  # (K,) i32 1 = leaf

    @property
    def count(self) -> int:
        return self.left.shape[0]


@_register(data=("node_min", "node_max", "tri", "miss"))
class LinkedBVH:
    """DFS-preorder skip-link BVH (see accel.bvh.flat_to_links) — the layout
    the device traversal actually walks.  hit-next is implicit (i+1);
    `miss[i]` jumps over i's subtree; `tri[i] >= 0` marks a leaf.  Termination
    sentinel is the padded node count."""

    node_min: jax.Array  # (K, 3)
    node_max: jax.Array  # (K, 3)
    tri: jax.Array  # (K,) i32, -1 for internal
    miss: jax.Array  # (K,) i32

    @property
    def count(self) -> int:
        return self.tri.shape[0]


@_register(data=("nodes", "tri_pos", "tri_shade", "tri_perm", "fat_nodes"))
class PackedGeometry:
    """Gather-friendly packed copies of the geometry + BVH for the hot loop.

    XLA compiles one wide gather per traversal step orders of magnitude
    faster than ten narrow ones (measured 150s -> 7s for the trace step), so
    the device tracer walks these instead of the SoA fields:

      nodes:     (K, 8)  f32 = [min.xyz, max.xyz, bitcast(tri), bitcast(miss)]
                 in skip-link DFS order (see accel.bvh.flat_to_links)
      tri_pos:   (N, 9)  f32 = [p0, p1, p2]
      tri_shade: (N, 10) f32 = [n0, n1, n2, bitcast(material_idx)]
      tri_perm:  (N,)    i32 = original triangle index of each packed row
      fat_nodes: (K2, 81) f32 fat-leaf skip-link rows (accel.bvh.links_to_fat):
                 box + miss link + up to 8 inlined triangles per node — the
                 large-scene traversal layout (ops/intersect.bvh_fat_intersect)

    Triangle rows are laid out in BVH-DFS *leaf order* (spatially coherent),
    so fixed-size row chunks are tight treelets.  `nodes` leaf
    pointers index the reordered rows; `tri_perm` maps a Hit.tri back to
    the `Triangles`/`FlatBVH` original order.

    Materials and the environment stay unpacked — they are the
    differentiable leaves.
    """

    nodes: jax.Array
    tri_pos: jax.Array
    tri_shade: jax.Array
    tri_perm: jax.Array
    fat_nodes: jax.Array


@_register(
    data=("radiance", "marginal_cdf", "conditional_cdf", "pdf", "sample_pdf"),
)
class EnvironmentMap:
    """Equirectangular environment map + CDF tables for importance sampling.

    The reference builds the CDF tables on the CPU and packs them into a
    second rgba32float texture (marginal, conditional, pdf, 1)
    (src/renderer.ts:132-281).  We keep them as separate arrays.

    `pdf` is the reference's packed channel — the sin-weighted luminance
    itself (renderer.ts:253-266), which is NOT a probability density (its
    importance-sampling consumer shipped commented out, raytrace.wgsl:398,
    so the reference never validated it).  `sample_pdf` is the TRUE
    uv-measure density of the CDF sampler (scene/envmap.build_cdf_tables),
    which is what the enabled estimator divides by — validated unbiased in
    tests/test_envmap.py.
    """

    radiance: jax.Array  # (H, W, 3) f32
    marginal_cdf: jax.Array  # (H, W) f32 (constant along W, kept 2D to mirror the texture)
    conditional_cdf: jax.Array  # (H, W) f32
    pdf: jax.Array  # (H, W) f32, reference-packed channel (weighted luminance)
    sample_pdf: jax.Array  # (H, W) f32, true uv-density of the CDF sampler

    @property
    def height(self) -> int:
        return self.radiance.shape[0]

    @property
    def width(self) -> int:
        return self.radiance.shape[1]

    @classmethod
    def black(cls, height: int = 8, width: int = 16) -> "EnvironmentMap":
        z = jnp.zeros((height, width), jnp.float32)
        return cls(
            radiance=jnp.zeros((height, width, 3), jnp.float32),
            marginal_cdf=z,
            conditional_cdf=z,
            pdf=z,
            sample_pdf=z,
        )


@_register(data=("triangles", "materials", "bvh", "links", "packed", "env"))
class SceneData:
    """The fully-compiled device scene: everything the trace step reads.

    `bvh` is the reference-contract flat layout (kept for parity checks and
    export); `links` is the skip-link layout; `packed` is what the hot
    traversal actually gathers from."""

    triangles: Triangles
    materials: Materials
    bvh: FlatBVH
    links: LinkedBVH
    packed: PackedGeometry
    env: EnvironmentMap


@_register(data=("position", "direction", "fov", "focal_distance", "aperture"))
class Camera:
    """Thin-lens camera (reference Camera struct raytrace.wgsl:10-16; defaults
    from RaytracingCamera, src/scene.ts:7-10: focalDistance=1, aperture=0)."""

    position: jax.Array  # (3,)
    direction: jax.Array  # (3,) need not be normalized; normalized in ray-gen
    fov: jax.Array  # scalar, degrees (vertical, like three.js PerspectiveCamera)
    focal_distance: jax.Array  # scalar
    aperture: jax.Array  # scalar

    @classmethod
    def create(
        cls,
        position=(0.0, 1.0, 4.0),
        direction=None,
        look_at=None,
        fov: float = 45.0,
        focal_distance: float = 1.0,
        aperture: float = 0.0,
    ) -> "Camera":
        pos = np.asarray(position, np.float32)
        if direction is None:
            if look_at is not None:
                direction = np.asarray(look_at, np.float32) - pos
            else:
                direction = np.array([0.0, 0.0, -1.0], np.float32)
        d = np.asarray(direction, np.float32)
        d = d / np.linalg.norm(d)
        return cls(
            position=jnp.asarray(pos),
            direction=jnp.asarray(d),
            fov=jnp.float32(fov),
            focal_distance=jnp.float32(focal_distance),
            aperture=jnp.float32(aperture),
        )


@_register(data=("camera", "frame", "env_intensity", "env_rotation"))
class RenderParams:
    """Per-frame traced parameters (the reference's Uniforms minus the static
    shape data; raytrace.wgsl:66-75)."""

    camera: Camera
    frame: jax.Array  # scalar u32/i32, 1-based like the reference frame counter
    env_intensity: jax.Array  # scalar
    env_rotation: jax.Array  # scalar, radians

    @classmethod
    def create(
        cls, camera: Camera, frame: int = 1, env_intensity: float = 1.0, env_rotation: float = 0.0
    ) -> "RenderParams":
        return cls(
            camera=camera,
            frame=jnp.uint32(frame),
            env_intensity=jnp.float32(env_intensity),
            env_rotation=jnp.float32(env_rotation),
        )


def pad_pow2(n: int, minimum: int = 1) -> int:
    """Next power of two >= max(n, minimum)."""
    n = max(n, minimum)
    return 1 << (n - 1).bit_length()
