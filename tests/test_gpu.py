"""Checks that only mean something on the card (``gpu`` marker: they skip
on the CPU; ``VNLB_TEST_GPU=1 python -m pytest -m gpu tests/`` or
chip_smoke.py runs them), plus their helpers at a tiny size on the CPU.

On the GPU, f32 matmuls at default precision may run as TF32, cuDNN picks
its own convolution algorithms and XLA may fuse the search's box sums
differently — each check pins a fast path to its plain reference at the
DAVIS-480p size the benchmark runs.
"""

import numpy as np
import pytest

from vnlb_tpu.ops import color
from vnlb_tpu.testing.parity import (arena_exact, bench_config, smoke_clip,
                                     strided_parity)
from vnlb_tpu.utils.metrics import compute_psnr


def _yuv(x):
    import jax.numpy as jnp

    return np.asarray(color.rgb2yuv(jnp.asarray(x)))


@pytest.mark.gpu
def test_poly_matches_exact_eigh_480p(gpu):
    """Benchmark configuration: poly basic and deno PSNR within 0.1 dB of
    exact eigh (cuSOLVER, HIGHEST-precision projections)."""
    from vnlb_tpu import denoise

    clean, noisy = smoke_clip()
    psnr = {}
    for eig in ("poly", "xla"):
        deno, basic, _ = denoise(noisy, 20.0,
                                 cfg=bench_config(20.0, eig_method=eig))
        psnr[eig] = (compute_psnr(np.asarray(basic), clean),
                     compute_psnr(np.asarray(deno), clean))
    assert abs(psnr["poly"][0] - psnr["xla"][0]) <= 0.1, psnr
    assert abs(psnr["poly"][1] - psnr["xla"][1]) <= 0.1, psnr


@pytest.mark.gpu
@pytest.mark.parametrize("stage", [0, 1])
def test_strided_search_parity_480p(gpu, stage):
    """Strided-query search == all-pixels search (level 0 and the needle
    coarse levels); a reassociated box sum may only move values by 1e-6
    relative and swap near-tie indices."""
    _, noisy = smoke_clip()
    r = strided_parity(_yuv(noisy), bench_config().stage(stage))
    assert ((r["values_equal"] and r["inds_equal"])
            or (r["max_rel"] <= 1e-6 and r["idx_agree"] >= 0.999)), r


@pytest.mark.gpu
def test_arena_conv_exact_480p(gpu):
    """The one-hot-convolution arenas are bitwise the slice form."""
    _, noisy = smoke_clip()
    yuv = _yuv(noisy)
    r = arena_exact(yuv, yuv[::-1].copy())
    assert all(r.values()), r


def test_strided_parity_helper_small():
    _, noisy = smoke_clip(3, 48, 52)
    for stage in (0, 1):
        r = strided_parity(_yuv(noisy),
                           bench_config(nwt_b=1, nwt_f=1).stage(stage))
        assert r["values_equal"] and r["inds_equal"], r


def test_arena_exact_helper_small():
    _, noisy = smoke_clip(3, 20, 24)
    yuv = _yuv(noisy)
    r = arena_exact(yuv, yuv[::-1].copy())
    assert set(r) == {"im2col_conv_bf16", "arena_conv_bf16",
                      "im2col_conv_f32", "arena_conv_f32"}
    assert all(r.values()), r
