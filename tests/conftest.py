"""Test harness config.

By default every test runs on the CPU, on a virtual 8-device mesh
(SURVEY.md §4: sharding tests compare 1-device vs n-device execution via
--xla_force_host_platform_device_count).  ``VNLB_TEST_GPU=1`` leaves JAX
on its default platform instead, so the ``gpu``-marked tests run on the
card: ``VNLB_TEST_GPU=1 python -m pytest -m gpu tests/`` (chip_smoke.py
runs them in its own process).  Whether a card is present is decided by
the ``gpu`` fixture when a test runs, never at import.
"""

import os

ON_GPU = bool(os.environ.get("VNLB_TEST_GPU"))

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    # The persistent compilation cache is off for the CPU suite: XLA:CPU
    # executables (de)serialize unreliably across hosts with different CPU
    # features (observed segfaults in the cache's get/put paths).
    os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    os.environ["VNLB_TPU_NO_CACHE"] = "1"     # vnlb_tpu/utils/cache honors it

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first JAX device, which must be a GPU; skips otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with VNLB_TEST_GPU=1 on a "
                    "machine with one, or through chip_smoke.py)")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables after each test module.

    The XLA:CPU backend segfaulted compiling the 8-device shard_map module
    late in a long suite run (the same test passes solo, and passes
    in-suite once earlier modules' executables are released).  Cross-module
    jit reuse is minimal (modules compile distinct shapes), so this costs
    little.
    """
    yield
    jax.clear_caches()
