"""Backend probing and the persistent compilation cache.

CLI tools dispatch between native-host and device compute paths. Importing
jax costs ~1.5s per process; when the environment pins JAX_PLATFORMS=cpu
(test runs, host-reference runs, CPU-only hosts) the answer is known
without importing it.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

# fixed in-checkout location: the cache key includes the path, so a
# directory that moved between runs would never hit
DEFAULT_CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")


def has_accelerator() -> bool:
    """True when jax's default backend is an accelerator (not the CPU)."""
    if "jax" not in sys.modules:
        if os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu":
            return False
    import jax
    return jax.default_backend() != "cpu"


def enable_compilation_cache() -> str:
    """Turn on jax's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set; otherwise the cache lives
    at DEFAULT_CACHE_DIR. Every executable is cached, however small or
    quick to compile. Before jax is imported the settings go through the
    environment (so a CLI run that never touches the device never imports
    jax); afterwards through jax.config."""
    settings = {
        "JAX_COMPILATION_CACHE_DIR": DEFAULT_CACHE_DIR,
        "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "-1",
        "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
    }
    settings = {k: os.environ.get(k) or v for k, v in settings.items()}
    cache_dir = settings["JAX_COMPILATION_CACHE_DIR"]
    os.makedirs(cache_dir, exist_ok=True)
    if "jax" in sys.modules:
        import jax
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", int(
            settings["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"]))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", float(
            settings["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"]))
    else:
        os.environ.update(settings)
    return cache_dir
