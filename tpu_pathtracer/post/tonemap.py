"""Tone-mapping operators (reference: src/passes/shaders/fullscreen.wgsl:88-126)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Tonemap

# WGSL mat3x3f is column-major: each row below is one constructor column
# (fullscreen.wgsl:89-98), so as numpy matrices M @ v = sum_i col_i * v_i.
_ACES_M1 = np.array(
    [
        [0.59719, 0.35458, 0.04823],
        [0.07600, 0.90834, 0.01566],
        [0.02840, 0.13383, 0.83777],
    ],
    np.float32,
)
_ACES_M2 = np.array(
    [
        [1.60475, -0.53108, -0.07367],
        [-0.10208, 1.10813, -0.00605],
        [-0.00327, -0.07276, 1.07602],
    ],
    np.float32,
)


def _mat3(color, m):
    """color @ m.T in true float32: a float32 matmul may otherwise run in
    TF32 on the GPU."""
    return jnp.matmul(color, m.T, precision=jax.lax.Precision.HIGHEST)


def aces_tonemap(color):
    """ACES fitted curve incl. the final 1/2.2 gamma (fullscreen.wgsl:88-103)."""
    v = _mat3(color, _ACES_M1)
    a = v * (v + np.float32(0.0245786)) - np.float32(0.000090537)
    b = v * (np.float32(0.983729) * v + np.float32(0.4329510)) + np.float32(0.238081)
    out = _mat3(a / b, _ACES_M2)
    return jnp.clip(out, 0.0, 1.0) ** np.float32(1.0 / 2.2)


def reinhard_tonemap(color):
    """color / (color + 1) (fullscreen.wgsl:105-107)."""
    return color / (color + 1.0)


def tonemap(color, mode: Tonemap):
    if mode == Tonemap.ACES:
        return aces_tonemap(color)
    if mode == Tonemap.REINHARD:
        return reinhard_tonemap(color)
    return color
