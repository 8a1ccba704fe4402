"""tpu_pathtracer: a differentiable, progressive path-tracing framework
built from scratch in JAX/XLA/Pallas, running on NVIDIA GPUs.

Capability surface mirrors the reference WebGPU path tracer
(umar-ahmed/webgpu-pathtracer; see SURVEY.md): thin-lens camera with DoF + AA, SAH BVH + Möller–Trumbore,
multi-bounce indirect lighting, equirect environment lighting with CDF
importance-sampling infrastructure, progressive accumulation with
start/pause/reset, ACES/Reinhard tone-mapping, bilateral denoise, resolution
scaling, glTF import, per-kernel timing — plus additions: a fused GPU
intersection kernel for the hot path, multi-device sharding via shard_map,
and end-to-end differentiability.
"""

from .config import PostConfig, RenderConfig, ShardConfig, Tonemap
from .scene.types import (
    Camera,
    EnvironmentMap,
    FlatBVH,
    Materials,
    RenderParams,
    SceneData,
    Triangles,
)
from .scene.host import Material, Mesh, Scene, default_scene
from .render.renderer import Renderer

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "EnvironmentMap",
    "FlatBVH",
    "Material",
    "Materials",
    "Mesh",
    "PostConfig",
    "RenderConfig",
    "RenderParams",
    "Renderer",
    "Scene",
    "SceneData",
    "ShardConfig",
    "Tonemap",
    "Triangles",
    "default_scene",
]
