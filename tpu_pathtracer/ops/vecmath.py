"""Small vector helpers over trailing-axis-3 arrays (f32)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Host-side scalars on purpose: a module-level jnp scalar would live on the
# default accelerator and every jit *lowering* that captures it as a constant
# would fetch it device->host.
INF = np.float32(1e20)  # raytrace.wgsl:6
EPSILON = np.float32(1e-6)  # raytrace.wgsl:7


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def normalize(v):
    n = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    return v / n


def reflect(d, n):
    """WGSL reflect: d - 2*dot(d,n)*n."""
    return d - 2.0 * dot(d, n)[..., None] * n


def mix(a, b, t):
    return a + (b - a) * t
