"""vnlb_tpu — a JAX/XLA Video Non-Local Bayes framework.

Ground-up re-design of the VNLB video denoiser (Arias & Morel, JMIV 2018)
with the capability surface of the reference implementation (see SURVEY.md):
two-pass empirical-Bayes patch denoising with flow-aware space-time patch
search, batched eigen-filtering, and on-device aggregation.

Public API parity (reference lib/vnlb/__init__.py:14-16):
    denoise, denoise_mod, proc_nl, proc_nl_cache, proc_nn
"""

from .utils.cache import enable_compile_cache as _enable_compile_cache

# persistent XLA compilation cache ON BY DEFAULT (utils/cache.py)
_enable_compile_cache()

from .api import (denoise, denoise_mod, denoise_streaming,
                  proc_nl_cache, proc_nn)
from .config import StageConfig, VnlbConfig, default_config
from .pipeline import proc_nl

__version__ = "0.1.0"

__all__ = [
    "denoise", "denoise_mod", "denoise_streaming", "proc_nl",
    "proc_nl_cache", "proc_nn",
    "StageConfig", "VnlbConfig", "default_config",
]
