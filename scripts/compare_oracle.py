#!/usr/bin/env python
"""Full-pipeline parity harness (reference scripts/compare_cpp.py +
docs/COMPARE.md protocol): runs the two-pass JAX pipeline and the C++ oracle
on the same clip and prints a markdown table of per-field relative errors
and PSNR deltas.

The reference compared against Pablo Arias' external C++ binary via
downloaded golden files; this framework ships its own C++ oracle
(vnlb_tpu/oracle/) so the comparison is hermetic.
"""

import _bootstrap  # noqa: F401
import argparse

import numpy as np

from vnlb_tpu import default_config, denoise
from vnlb_tpu.testing.data import load_dataset
from vnlb_tpu.testing.oracle import oracle_denoise
from vnlb_tpu.utils.metrics import compute_psnr


def rel_error(a, b):
    return float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-10))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="davis_64x64")
    ap.add_argument("--sigma", type=float, default=20.0)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--eig", default="jacobi",
                    help="jacobi (exact parity) | rational (fast path)")
    args = ap.parse_args()

    data = load_dataset(args.dataset, sigma=args.sigma)
    clean = data["clean"][:args.frames, :, :args.size, :args.size]
    noisy = data["noisy"][:args.frames, :, :args.size, :args.size]

    # l2 stype: the oracle's needle pyramid matches, but l2 is the
    # docs/COMPARE.md protocol
    cfg = default_config(args.sigma, preset="iphone",
                         stype=["l2", "l2"], eig_method=args.eig)

    deno, basic, dtime = denoise(noisy, args.sigma, cfg=cfg)
    deno, basic = np.asarray(deno), np.asarray(basic)

    print("running C++ oracle (sequential, double precision)...")
    o_deno, o_basic = oracle_denoise(noisy, args.sigma, cfg)

    rows = [
        ("basic rel. error", f"{rel_error(basic, o_basic):.6f}", ""),
        ("deno rel. error", f"{rel_error(deno, o_deno):.6f}", ""),
        ("PSNR oracle (basic/deno)",
         f"{compute_psnr(o_basic, clean):.4f}",
         f"{compute_psnr(o_deno, clean):.4f}"),
        ("PSNR jax (basic/deno)",
         f"{compute_psnr(basic, clean):.4f}",
         f"{compute_psnr(deno, clean):.4f}"),
        ("PSNR abs. delta (basic/deno)",
         f"{abs(compute_psnr(basic, clean) - compute_psnr(o_basic, clean)):.4f}",
         f"{abs(compute_psnr(deno, clean) - compute_psnr(o_deno, clean)):.4f}"),
        ("jax wall time", f"{dtime:.2f}s",
         f"{clean.shape[0] / dtime:.2f} fps"),
    ]
    print("\n| metric | value | value2 |")
    print("|---|---|---|")
    for r in rows:
        print(f"| {r[0]} | {r[1]} | {r[2]} |")


if __name__ == "__main__":
    main()
