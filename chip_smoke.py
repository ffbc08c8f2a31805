#!/usr/bin/env python
"""Smoke test of the two-pass denoiser on NVIDIA GPUs.

    python chip_smoke.py            # one card, 480p checks (default)
    python chip_smoke.py --four     # only the four-card halo-SP path

One card: drives ``vnlb_tpu.denoise`` on a seeded synthetic DAVIS-class
clip (5x3x480x854, sigma 20) in the public default configuration and in
the benchmark configuration (poly filter, stride 6, masked borders),
then checks the poly filter against exact eigh, the strided-query search
against the all-pixels search, the one-hot-convolution patch arenas
against the plain slice form, reports run-to-run determinism, and runs the
``gpu``-marked tests in this process.

``--four``: the halo-SP mesh path (``parallel.halo.denoise_halo`` on a
4-card ``h`` mesh) on a 5x3x1080x1920 clip against the one-card
``denoise`` of the same clip on device 0.

Exits non-zero without printing the result line when JAX finds no GPU or
any phase fails.  The last line of stdout is one JSON object naming the
device.  One process drives every card it uses.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
ONE_CARD_PHASES = ("denoise", "exact", "search", "arena", "determinism",
                   "gpu_tests")
FOUR_CARD_PHASES = ("four",)
SIGMA = 20.0


def phases_for(four: bool):
    """The phases a run executes: ``--four`` runs its path alone."""
    return FOUR_CARD_PHASES if four else ONE_CARD_PHASES


def gpu_devices(count: int):
    """The JAX devices, which must be at least ``count`` GPUs; exits
    non-zero otherwise (there is no CPU fallback)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found (JAX platform "
                         f"{devs[0].platform!r}); this smoke test runs only "
                         f"on an NVIDIA GPU")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found "
                         f"{len(devs)}")
    return devs[:count]


def card_lines():
    """``name, power.limit`` of every card, as nvidia-smi prints them (read
    by a child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def contract_line(devs) -> str:
    """The result line: the devices as JAX reports them."""
    return json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}})


def log(msg: str):
    print(msg, flush=True)


def _check(ok: bool, detail):
    """Fail the run (never skipped, unlike ``assert`` under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {detail}")


def _psnr(x, clean) -> float:
    import numpy as np

    from vnlb_tpu.utils.metrics import compute_psnr

    return compute_psnr(np.asarray(x), clean)


def _peak_bytes(dev) -> int:
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", -1))


def _timed(fn, reps: int):
    """(first-call seconds, [rep seconds], [rep outputs]); each call ends
    in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    setup = time.perf_counter() - t0
    times, outs = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
        outs.append(out)
    return setup, times, outs


def run_denoise(name, noisy, clean, cfg, dev, reps: int = 3):
    """One configuration through ``vnlb_tpu.denoise``: set-up, median rep
    time, PSNRs, peak memory.  Returns (psnr_basic, psnr_deno, outputs of
    every rep)."""
    from vnlb_tpu import denoise

    setup, times, outs = _timed(
        lambda: denoise(noisy, SIGMA, cfg=cfg)[:2], reps)
    deno, basic = outs[-1]
    p_noisy = _psnr(noisy, clean)
    p_basic, p_deno = _psnr(basic, clean), _psnr(deno, clean)
    log(f"[{name}] setup (compile + first run) {setup:.3f} s; reps "
        f"{[round(x, 4) for x in times]} s; median "
        f"{statistics.median(times):.4f} s, spread "
        f"{max(times) - min(times):.4f} s")
    log(f"[{name}] psnr noisy {p_noisy:.4f} basic {p_basic:.4f} deno "
        f"{p_deno:.4f} dB; peak_bytes_in_use so far {_peak_bytes(dev)}")
    _check(p_deno >= p_noisy + 6.0, (name, p_noisy, p_deno))
    return p_basic, p_deno, outs


def run_search_timing(noisy, scfg):
    """One jitted exec_search_dense call (stage-0 lattice search) beside
    the whole stage-0 pass, both ended by block_until_ready."""
    import jax.numpy as jnp

    from vnlb_tpu.api import _prep_flows
    from vnlb_tpu.ops import color
    from vnlb_tpu.ops.mask import lattice_sites
    from vnlb_tpu.ops.search_dense import exec_search_dense
    from vnlb_tpu.pipeline import proc_nl
    from vnlb_tpu.testing.parity import lattice_phases

    shape = noisy.shape
    srch = color.rgb2yuv(jnp.asarray(noisy))
    sites = jnp.asarray(lattice_sites(shape, scfg))
    qrow0 = lattice_phases(shape, scfg)
    s_setup, s_times, _ = _timed(
        lambda: exec_search_dense(srch, sites, scfg, qrow0=qrow0), 3)
    ff, bf, _ = _prep_flows(shape, None)
    p_setup, p_times, _ = _timed(
        lambda: proc_nl(noisy, None, None, ff, bf, scfg, zero_flow=True), 3)
    s_med, p_med = statistics.median(s_times), statistics.median(p_times)
    log(f"[search] stage-0 exec_search_dense ({sites.shape[0]} sites): "
        f"median {s_med:.4f} s of the stage-0 pass median {p_med:.4f} s "
        f"({100 * s_med / p_med:.1f}%); setup {s_setup:.2f} / "
        f"{p_setup:.2f} s")


def phase_denoise(ctx):
    """The public default, then the benchmark configuration."""
    import jax

    from vnlb_tpu import default_config
    from vnlb_tpu.testing.parity import bench_config, smoke_clip

    t, h, w = ctx["size"]
    clean, noisy = smoke_clip(t, h, w, SIGMA)
    ctx.update(clean=clean, noisy=noisy)
    log(f"[clip] {t}x3x{h}x{w} sigma {SIGMA}; matmul precision "
        f"{jax.config.jax_default_matmul_precision or 'default'} (f32 "
        f"matmuls may run as TF32; poly_bf16 stores iterates in bf16)")
    run_denoise("default", noisy, clean, default_config(SIGMA),
                ctx["devs"][0])
    ctx["bench"] = run_denoise("bench", noisy, clean, bench_config(SIGMA),
                               ctx["devs"][0])


def phase_exact(ctx):
    """Poly filter vs exact eigh (cuSOLVER, HIGHEST-precision projections)
    on the same clip: basic and deno PSNR within 0.1 dB."""
    from vnlb_tpu.testing.parity import bench_config

    pb, pd, _ = ctx["bench"]
    xb, xd, _ = run_denoise("exact", ctx["noisy"], ctx["clean"],
                            bench_config(SIGMA, eig_method="xla"),
                            ctx["devs"][0], reps=1)
    log(f"[exact] poly - exact: basic {pb - xb:+.4f} dB, deno "
        f"{pd - xd:+.4f} dB (budget 0.1 dB)")
    _check(abs(pb - xb) <= 0.1 and abs(pd - xd) <= 0.1, (pb, xb, pd, xd))
def phase_search(ctx):
    """Strided-query search vs the all-pixels search, both stages of the
    benchmark configuration (level 0 and the needle coarse levels)."""
    import jax.numpy as jnp
    import numpy as np

    from vnlb_tpu.ops import color
    from vnlb_tpu.testing.parity import bench_config, strided_parity

    bcfg = bench_config(SIGMA)
    run_search_timing(ctx["noisy"], bcfg.stage(0))
    ctx["yuv"] = np.asarray(color.rgb2yuv(jnp.asarray(ctx["noisy"])))
    for i in (0, 1):
        r = strided_parity(ctx["yuv"], bcfg.stage(i))
        exact = r["values_equal"] and r["inds_equal"]
        held = ("bit-equal" if exact else "rel <= 1e-6, index agreement "
                ">= 99.9%")
        log(f"[search] stage {i} ({bcfg.stage(i).stype}) strided vs full: "
            f"{r} -> {held}")
        _check(exact or (r["max_rel"] <= 1e-6
                         and r["idx_agree"] >= 0.999), r)
def phase_arena(ctx):
    """One-hot-convolution patch arenas vs the slice form, bitwise."""
    import numpy as np

    from vnlb_tpu.ops import color
    from vnlb_tpu.testing.parity import arena_exact

    basic = ctx["bench"][2][-1][1]
    r = arena_exact(ctx["yuv"], np.asarray(color.rgb2yuv(basic)))
    log(f"[arena] bitwise equal to the slice form: {r}")
    _check(all(r.values()), r)
def phase_determinism(ctx):
    """Reported, not asserted: are two bench reps bitwise equal?"""
    import numpy as np

    d1, d2 = (np.asarray(o[0]) for o in ctx["bench"][2][-2:])
    log(f"[determinism] bench deno rep-to-rep bitwise equal: "
        f"{bool(np.array_equal(d1, d2))}; max abs diff "
        f"{float(np.abs(d1 - d2).max())}")


class _Outcomes:
    """pytest plugin: counts passed tests and everything else."""

    def __init__(self):
        self.passed, self.other = 0, []

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed += 1
        elif report.failed or report.skipped:
            self.other.append((report.nodeid, report.outcome))


def phase_gpu_tests(ctx):
    """The ``gpu``-marked tests, in this process (one process per card)."""
    import pytest

    os.environ["VNLB_TEST_GPU"] = "1"
    seen = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(REPO / "tests" / "test_gpu.py")], plugins=[seen])
    log(f"[gpu_tests] rc {rc}; passed {seen.passed}; other {seen.other}")
    _check(rc == 0 and seen.passed >= 3 and not seen.other,
           (rc, seen.passed, seen.other))


def phase_four(ctx):
    """Halo-SP over a 4-card mesh vs the one-card denoise on devs[0]."""
    import jax

    from vnlb_tpu import default_config, denoise
    from vnlb_tpu.parallel.halo import denoise_halo
    from vnlb_tpu.parallel.tiled import make_mesh
    from vnlb_tpu.testing.parity import smoke_clip

    devs = ctx["devs"]
    clean, noisy = smoke_clip(*ctx["size"], SIGMA)
    cfg = default_config(SIGMA, preset="iphone", border_mode="mask")
    mesh = make_mesh(axis="h", devices=devs)
    setup, times, outs = _timed(
        lambda: denoise_halo(noisy, SIGMA, mesh=mesh, cfg=cfg), 1)
    hd, hb = outs[-1]
    log(f"[four] halo-SP on {len(devs)} cards: setup {setup:.3f} s, wall "
        f"{times[0]:.4f} s")
    # one card: the low-memory streaming top-K (bit-equal to the one-shot
    # top-K) keeps the 1080p candidate buffer within one card
    cfg1 = default_config(SIGMA, preset="iphone", border_mode="mask",
                          topk="stream")
    with jax.default_device(devs[0]):
        setup1, times1, outs1 = _timed(
            lambda: denoise(noisy, SIGMA, cfg=cfg1)[:2], 1)
    od, ob = outs1[-1]
    log(f"[four] one card: setup {setup1:.3f} s, wall {times1[0]:.4f} s")
    d_b = _psnr(hb, clean) - _psnr(ob, clean)
    d_d = _psnr(hd, clean) - _psnr(od, clean)
    log(f"[four] psnr one card basic {_psnr(ob, clean):.4f} deno "
        f"{_psnr(od, clean):.4f} dB; halo - one card: basic {d_b:+.4f} "
        f"dB, deno {d_d:+.4f} dB (budget 0.05 dB)")
    _check(abs(d_b) <= 0.05 and abs(d_d) <= 0.05, (d_b, d_d))
PHASES = {"denoise": phase_denoise, "exact": phase_exact,
          "search": phase_search, "arena": phase_arena,
          "determinism": phase_determinism, "gpu_tests": phase_gpu_tests,
          "four": phase_four}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card halo-SP path")
    args = ap.parse_args(argv)
    if args.four:
        # one process drives all four cards; leave the one-card 1080p
        # reference room beyond JAX's default three-quarter reservation
        os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.9")
    devs = gpu_devices(4 if args.four else 1)
    import jax

    for line in card_lines():
        log(line)
    log(f"jax {jax.__version__}; devices {[d.device_kind for d in devs]}")
    import vnlb_tpu  # noqa: F401  (compile cache: vnlb_tpu/utils/cache.py)

    ctx = {"devs": devs, "size": (5, 1080, 1920) if args.four
           else (5, 480, 854)}
    t0 = time.perf_counter()
    for phase in phases_for(args.four):
        PHASES[phase](ctx)
    log(f"[total] {time.perf_counter() - t0:.1f} s")
    print(contract_line(devs), flush=True)


if __name__ == "__main__":
    sys.exit(main())
