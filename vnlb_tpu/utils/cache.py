"""Location of the persistent XLA compilation cache.

The two-pass 480p pipeline compiles for minutes cold and seconds warm, so
``import vnlb_tpu`` turns JAX's persistent compilation cache on.  Where
``JAX_COMPILATION_CACHE_DIR`` is set, the cache lives there and nowhere
else; otherwise it lives at a fixed path inside the checkout
(``<repo>/.cache/jax``, listed in .gitignore) — the path is part of the
cache key, so a location that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".cache" / "jax"


def cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.cache/jax``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_CACHE_DIR)


def enable_compile_cache() -> Optional[str]:
    """Point JAX's persistent compilation cache at ``cache_dir()``.

    Skipped (returns None) with ``VNLB_TPU_NO_CACHE=1`` and in processes
    pinned to the CPU: XLA:CPU executables (de)serialize unreliably across
    hosts with different CPU features."""
    if (os.environ.get("VNLB_TPU_NO_CACHE")
            or os.environ.get("JAX_PLATFORMS", "").strip() == "cpu"):
        return None
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
