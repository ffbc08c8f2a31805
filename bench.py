#!/usr/bin/env python
"""Headline benchmark: DAVIS-480p two-pass VNLB denoising throughput.

Prints ONE JSON line:
  {"metric": "davis480p_fps", "value": N, "unit": "frames/sec",
   "vs_baseline": N / 0.0345}
where vs_baseline compares against the REFERENCE implementation's measured
throughput (~2m25s for 5 frames of 480p => 0.0345 fps, C++ OpenMP and
Python+GPU alike per BASELINE.md); the 30 fps north-star ratio is logged to
stderr.

Baseline context (BASELINE.md): the reference C++/OpenMP and Python+GPU
implementations both take ~2m25s for a 5-frame DAVIS-480p clip at sigma=20
(~0.034 fps); the north-star target is >=30 fps on one NVIDIA H100.
Every record names the device it ran on (platform, device kind, count,
power limit); without a GPU the script exits non-zero.  All progress
prints go to stderr; stdout carries only the JSON line.
"""

import json
import os
import statistics
import subprocess
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    t = int(os.environ.get("VNLB_BENCH_FRAMES", "5"))
    h = int(os.environ.get("VNLB_BENCH_H", "480"))
    w = int(os.environ.get("VNLB_BENCH_W", "854"))
    sigma = float(os.environ.get("VNLB_BENCH_SIGMA", "20"))
    preset = os.environ.get("VNLB_BENCH_PRESET", "iphone")
    reps = int(os.environ.get("VNLB_BENCH_REPS", "3"))
    # production fast path: polynomial spectral filter (ops/polyspec.py;
    # two-pass PSNR within 0.1 dB of the exact eigh mode for BOTH passes,
    # pinned by tests/test_polyspec.py)
    eig_method = os.environ.get("VNLB_BENCH_EIG", "poly")
    # coverage-lattice stride: 6 = the reference's MEASURED effective work
    # density.  The reference declares procStep 3 (params.py:30) but its
    # paste trick (mask.py:104-187: every matched patch corner + a +-1
    # dilation leaves the work mask) processes only 19-27% of the stride-3
    # lattice — equivalent stride ~6-7 (measured via the reference-order
    # compat mode, tests/test_compat.py::test_reference_density; docs/
    # COMPARE.md "Work density").  At that matched density the lattice
    # BEATS the reference-order quality (+0.2 dB basic).  The other
    # density (stride 3, the full lattice) is timed too, further below.
    step_s = int(os.environ.get("VNLB_BENCH_STEP", "6"))

    import jax
    import jax.numpy as jnp
    import numpy as np

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench: no GPU found (JAX platform "
                         f"{devs[0].platform!r}); device timings need one")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.splitlines()[0].strip()
    device = {"platform": devs[0].platform, "kind": devs[0].device_kind,
              "count": len(devs), "power_limit": card.split(",")[-1].strip()}

    from vnlb_tpu import default_config, denoise
    from vnlb_tpu.testing.data import add_noise, synthetic_video
    from vnlb_tpu.utils.metrics import compute_psnr

    t_start = time.perf_counter()
    log(f"[bench] devices: {devs}; card: {card}")
    log(f"[bench] clip: t={t} {h}x{w} sigma={sigma} preset={preset}")

    clean = synthetic_video(t, h, w, seed=0)
    noisy = add_noise(clean, sigma, seed=1)
    # masked-border search: every site rides the dense fast path (the +inf
    # OOB masking deltas only the 7-px border band; PSNR effect pinned by
    # tests/test_border_mode.py and visible in the psnr line below)
    border = os.environ.get("VNLB_BENCH_BORDER", "mask")
    # topk: "exact" (one-shot), "approx" (lax.approx_max_k), "stream"
    # (low-memory per-dt merge) — see ops/search_dense.exec_search_dense
    topk = os.environ.get("VNLB_BENCH_TOPK", "exact")
    cfg = default_config(sigma, preset=preset, eig_method=eig_method,
                         step_s=step_s, border_mode=border, topk=topk)

    def run(c):
        out = denoise(noisy_dev, sigma, cfg=c)[:2]
        return jax.block_until_ready(out)

    def dev_psnr(x):
        return compute_psnr(np.asarray(x), clean)

    noisy_dev = jax.block_until_ready(jnp.asarray(noisy))

    # warmup (compile)
    t0 = time.perf_counter()
    deno, basic = run(cfg)
    log(f"[bench] warmup (incl. compile): {time.perf_counter() - t0:.1f}s")

    p_basic, p_deno = dev_psnr(basic), dev_psnr(deno)
    log(f"[bench] psnr noisy={compute_psnr(noisy, clean):.2f} "
        f"basic={p_basic:.2f} "
        f"deno={p_deno:.2f} dB")

    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        run(cfg)
        dt = time.perf_counter() - t0
        times.append(dt)
        log(f"[bench] rep {i}: {dt:.3f}s ({t / dt:.3f} fps)")

    med = statistics.median(times)
    fps = t / med
    # baseline = the reference implementation on the same task (BASELINE.md:
    # ~2m25s for 5 frames of 480p => 0.0345 fps, C++ OpenMP and Python+GPU
    # alike); the 30 fps north-star ratio goes to stderr
    ref_fps = 5.0 / 145.0
    log(f"[bench] vs reference impl: {fps / ref_fps:.1f}x; "
        f"vs 30fps north star: {fps / 30.0:.3f}")

    # achieved useful-FLOP rate (analytic model, utils/flops.py):
    # algorithmic patch-distance + filter-chain + aggregation work divided
    # by wall — padding lanes / discarded planes / recompute count as
    # overhead by construction
    from vnlb_tpu.ops.mask import lattice_sites
    from vnlb_tpu.utils.flops import two_pass_flops

    shape = (t, 3, h, w)
    ns0 = lattice_sites(shape, cfg.stage(0)).shape[0]
    ns1 = lattice_sites(shape, cfg.stage(1)).shape[0]
    fl = two_pass_flops(shape, cfg, ns0, ns1)
    log(f"[bench] useful work ~{fl / 1e9:.1f} GFLOP; achieved "
        f"~{fl / med / 1e12:.2f} TFLOP/s")

    # reference-semantics quality rep: the headline
    # defaults carry two measured quality-POSITIVE semantic deviations from
    # the reference (agg_k=32 aggregates only the 32 closest of K,
    # reference aggregates all K, lib/vnlb/agg/comp_agg.py:106-141; and
    # border_mode="mask" vs the reference's sliding window clamp).  One
    # extra rep with agg_k=0 + border_mode="slide" records the PSNR pair
    # under reference aggregation semantics so the parity story does not
    # silently include the improved defaults.
    extra = {}
    t_warm = time.perf_counter() - t_start
    if t_warm <= 900 and not os.environ.get("VNLB_BENCH_SKIP_REFSEM"):
        cfg_ref = default_config(sigma, preset=preset, eig_method=eig_method,
                                 step_s=step_s, border_mode="slide",
                                 agg_k=0, topk=topk)
        t0 = time.perf_counter()
        d_r, b_r = run(cfg_ref)
        p_basic_r, p_deno_r = dev_psnr(b_r), dev_psnr(d_r)
        log(f"[bench] reference-semantics (agg_k=0, slide borders): "
            f"basic={p_basic_r:.2f} deno={p_deno_r:.2f} dB "
            f"({time.perf_counter() - t0:.1f}s incl compile)")
        extra["psnr_basic_refsem_db"] = round(p_basic_r, 3)
        extra["psnr_deno_refsem_db"] = round(p_deno_r, 3)
    else:
        log("[bench] skipping reference-semantics rep (cold compiles)")

    # second work density: the full stride-3 lattice (~5x the reference's
    # measured effective work) — the conservative number, emitted alongside
    # the headline so the JSON alone shows both
    alt_step = 3 if step_s != 3 else 6
    # the alt-density pass compiles its own programs; if THIS config
    # already compiled cold for long, skip the alt rather than risk a
    # caller's timeout — the headline JSON still carries the primary
    # number
    t_warm = time.perf_counter() - t_start
    if t_warm > 900:
        log(f"[bench] skipping alt density (elapsed {t_warm:.0f}s — cold "
            f"compiles; re-run with a warm cache for both numbers)")
        os.environ.setdefault("VNLB_BENCH_SKIP_ALT", "1")
    if not os.environ.get("VNLB_BENCH_SKIP_ALT"):
        cfg_alt = default_config(sigma, preset=preset, eig_method=eig_method,
                                 step_s=alt_step, border_mode=border)
        t0 = time.perf_counter()
        run(cfg_alt)
        log(f"[bench] stride-{alt_step} warmup (incl. compile): "
            f"{time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        run(cfg_alt)
        dt_a = time.perf_counter() - t0
        fps_alt = t / dt_a
        log(f"[bench] stride-{alt_step}: {dt_a:.3f}s ({fps_alt:.3f} fps, "
            f"{fps_alt / ref_fps:.1f}x ref)")
        key = ("full_lattice_stride3" if alt_step == 3
               else "matched_density_stride6")
        extra[f"{key}_fps"] = round(fps_alt, 4)

    print(json.dumps({"metric": "davis480p_fps", "value": round(fps, 4),
                      "unit": "frames/sec",
                      "vs_baseline": round(fps / ref_fps, 4),
                      "work_density": f"stride{step_s}",
                      "psnr_basic_db": round(p_basic, 3),
                      "psnr_deno_db": round(p_deno, 3),
                      "reps_s": [round(x, 4) for x in times],
                      "device": device, **extra}))


if __name__ == "__main__":
    main()
