"""The one rule for JAX's persistent compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that
directory and nothing is changed. Otherwise the cache goes to
``<repo root>/.jax_cache`` — a fixed path (listed in .gitignore), so a
later process of the same checkout finds what an earlier one compiled.
Entry points (chip_smoke.py, bench.py, examples/, tools/, exp/) call
``use_compile_cache()`` once, before their first compilation.
"""
from __future__ import annotations

import os

import jax

ENV_CACHE_DIR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def use_compile_cache() -> str:
    """Apply the rule above; returns the cache directory in use."""
    env = os.environ.get(ENV_CACHE_DIR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
