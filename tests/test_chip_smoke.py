"""The parts of chip_smoke.py that a CPU can reach: it refuses to run
without a GPU, formats its result line from the devices JAX reports, and
``--four`` selects only the four-card phase.  Plus the compile-cache
location it relies on (vnlb_tpu/utils/cache.py)."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from vnlb_tpu.utils import cache

REPO = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_refuses_without_gpu_subprocess(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("four", [False, True])
def test_main_exits_without_gpu(four, monkeypatch):
    # --four sets a default memory fraction; keep it out of this process
    monkeypatch.setenv("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.75")
    with pytest.raises(SystemExit) as exc:
        _smoke().main(["--four"] if four else [])
    assert "no GPU" in str(exc.value.code)


def test_contract_line_names_the_devices():
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")] * 4
    line = _smoke().contract_line(devs)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100", "count": 4}}
    assert "\n" not in line


def test_four_selects_only_its_phase():
    smoke = _smoke()
    assert smoke.phases_for(True) == ("four",)
    one = smoke.phases_for(False)
    assert "four" not in one
    assert {"denoise", "exact", "search", "arena", "determinism",
            "gpu_tests"} == set(one)
    assert set(one) | {"four"} == set(smoke.PHASES)


def test_cache_dir_env_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.cache_dir() == str(REPO / ".cache" / "jax")


def test_cache_dir_env_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_cache_off_on_cpu(monkeypatch):
    monkeypatch.delenv("VNLB_TPU_NO_CACHE", raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert cache.enable_compile_cache() is None
