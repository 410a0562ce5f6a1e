"""Runtime configuration helpers.

The reference has no config system (compile-time constants, SURVEY.md §5);
here the few global knobs live in one place.
"""
from __future__ import annotations

import os

# In-checkout default for the persistent compile cache (listed in
# .gitignore). A fixed path: the cache key includes it, so a moving
# directory would never hit.
DEFAULT_CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".jax_cache"))


def compilation_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else DEFAULT_CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache so compiled programs are
    reused across processes. Honours JAX_COMPILATION_CACHE_DIR (JAX reads
    it itself) and sets no other directory then; otherwise uses
    DEFAULT_CACHE_DIR. Returns the cache directory."""
    import jax

    path = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


def force_cpu(n_devices: int | None = None) -> None:
    """Force the CPU backend (with an optional virtual device count) —
    must run before any device computation."""
    if n_devices is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={n_devices}"
            ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
