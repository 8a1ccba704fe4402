"""Persistent XLA compilation cache wiring.

A cold compile of the render step takes seconds to minutes, and every
`Renderer.set_option` change that alters a shape pays one.  JAX ships a
persistent on-disk compilation cache; this module turns it on once per
process so the viewer's first frame, repeat benchmark runs and
option-toggle re-renders hit the disk instead of the compiler.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory.  Otherwise the cache lives in one fixed
directory inside the checkout, ``<repo>/.jax_cache`` (listed in
.gitignore): the path is part of what a cache hit needs, so it must not
move from run to run.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)

_enabled = False


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache; returns its directory."""
    global _enabled
    import jax

    path = cache_dir()
    if _enabled:
        return path
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # Cache every program that took noticeable compile time, not just the
    # >1 s default, and regardless of size.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _enabled = True
    return path
