"""Configuration surface of the framework.

Mirrors the parameter surface of the reference renderer (see SURVEY.md §2 row 1):
the reference exposes every knob through a Tweakpane panel bound to renderer
properties (reference: src/main.ts:83-356, src/renderer.ts:39-41).  Here the
same surface is a set of frozen dataclasses, split by which layer consumes them.

Static vs. traced: anything that changes array shapes or unrolled loop counts
(resolution, spp, max_bounces) is *static* Python config baked into the jitted
render step; continuously-variable parameters (camera pose, env intensity /
rotation, frame index) live in `RenderParams` pytrees (see scene/types.py) and
can change without recompilation.
"""

from __future__ import annotations

import dataclasses
import enum


# Intersector names a user may choose (ops/trace.resolve_intersector).
INTERSECTORS = ("auto", "mt", "mt_pallas", "bvh", "bvh8")


class Tonemap(enum.IntEnum):
    """Tone-mapping operator (reference: src/passes/shaders/fullscreen.wgsl:5-7)."""

    NONE = 0
    ACES = 1
    REINHARD = 2


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Shape-defining render settings (compiled into the jitted step).

    Defaults follow the reference: 64 frames x 1 spp progressive budget
    (src/renderer.ts:40-41), 4 bounces (src/main.ts:84), scaling factor 0.25
    (src/renderer.ts:39).  Ranges the reference UI allows: frames 2-2048,
    samples_per_frame 1-16, max_bounces 0-10, scaling {0.1..1.0}
    (src/main.ts:167-200).
    """

    width: int = 256
    height: int = 256
    scaling_factor: float = 1.0
    frames: int = 64
    samples_per_frame: int = 1
    max_bounces: int = 4
    seed: int = 123456789  # SEED constant, raytrace.wgsl:1
    accumulate: bool = True
    # Intersection backend (INTERSECTORS): 'auto' picks by scene
    # size and backend (ops/trace.resolve_intersector); 'mt' (all-pairs
    # Möller–Trumbore in XLA), 'mt_pallas' (the same as a fused GPU kernel),
    # 'bvh' (skip-link traversal) and 'bvh8' (fat-leaf traversal) force one.
    intersector: str = "auto"
    # Blue-noise low-discrepancy AA jitter (the reference's dead asset made
    # live; ops/trace.render_frame blue_noise=...).  Not bit-compatible with
    # the reference's hash-jitter stream.
    blue_noise: bool = False

    @property
    def scaled_width(self) -> int:
        # Reference floors the scaled size (src/renderer.ts:310-320).
        return max(1, int(self.width * self.scaling_factor))

    @property
    def scaled_height(self) -> int:
        return max(1, int(self.height * self.scaling_factor))

    @property
    def total_spp(self) -> int:
        return self.frames * self.samples_per_frame


@dataclasses.dataclass(frozen=True)
class PostConfig:
    """Post-processing (fullscreen pass) settings.

    Denoise constants are the reference's hard-coded call
    `denoise(tex, uv, 5.0, 1.0, 0.08)` (fullscreen.wgsl:118).
    """

    denoise: bool = True
    tonemap: Tonemap = Tonemap.ACES
    denoise_sigma: float = 5.0
    denoise_k_sigma: float = 1.0
    denoise_threshold: float = 0.08


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """Device-mesh layout for the sharded render/train step.

    The image's tile axis shards over `tiles`; the sample axis shards over
    `samples`.  Radiance is psum'd over the sample axis and tiles are
    all-gathered for final image assembly (net-new vs. the single-queue
    reference; see SURVEY.md §2 'Parallelism & communication').
    """

    tiles: int = 1
    samples: int = 1

    @property
    def num_devices(self) -> int:
        return self.tiles * self.samples
