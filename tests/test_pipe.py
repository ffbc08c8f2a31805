"""Pipeline parallelism (SURVEY §2.3 PP): two passes on two devices,
overlapped over temporal chunks — output must equal denoise_streaming."""

import numpy as np
import pytest

from vnlb_tpu.api import denoise_streaming
from vnlb_tpu.config import default_config
from vnlb_tpu.parallel.pipe import denoise_pipelined
from vnlb_tpu.testing.data import add_noise, synthetic_video


def _small_cfg(sigma):
    # tiny temporal window so ctx = 2*nwt+pt-1 stays small and a 12-frame
    # clip yields true sub-window chunks
    return default_config(sigma, preset="iphone",
                          nwt_b=[1, 1], nwt_f=[1, 1], npatches=[12, 10],
                          bsize=[64, 64], border_mode=["mask", "mask"])


def test_pipelined_equals_streaming():
    sigma = 20.0
    clean = synthetic_video(12, 36, 40, seed=0)
    noisy = add_noise(clean, sigma, seed=1)
    cfg = _small_cfg(sigma)

    d_s, b_s, _ = denoise_streaming(noisy, sigma, chunk=3, cfg=cfg)
    d_p, b_p, _ = denoise_pipelined(noisy, sigma, chunk=3, cfg=cfg)

    # same chunk windows, same finalized basic frames, same lattice
    # anchoring -> identical computations on identical devices
    np.testing.assert_array_equal(b_p, b_s)
    np.testing.assert_array_equal(d_p, d_s)


def test_pipelined_halo_composition():
    """PP x SP: each pass halo-SP sharded over its own 2-device mesh
    (4 devices total = 2 pipeline stages x 2 H-strips) — the 8-device
    scale-out shape at test scale.  Must match the plain pipelined run up to
    halo-SP fp reassociation (the test_halo closeness bar)."""
    import jax

    from vnlb_tpu.parallel.tiled import make_mesh

    sigma = 20.0
    clean = synthetic_video(8, 28, 56, seed=4)
    noisy = add_noise(clean, sigma, seed=5)
    cfg = _small_cfg(sigma)

    devs = jax.devices()
    assert len(devs) >= 4, "conftest provisions an 8-device CPU mesh"
    m1 = make_mesh(axis="h", devices=devs[:2])
    m2 = make_mesh(axis="h", devices=devs[2:4])

    d_p, b_p, _ = denoise_pipelined(noisy, sigma, chunk=2, cfg=cfg)
    d_h, b_h, _ = denoise_pipelined(noisy, sigma, chunk=2, cfg=cfg,
                                    meshes=(m1, m2))
    assert d_h.shape == noisy.shape
    # halo fp reassociation swaps isolated near-tie candidates, which can
    # move single pixels by ~1 (and pass 2 consumes the reassociated
    # basic); the meaningful bars are aggregate: mean-relative + PSNR
    from vnlb_tpu.utils.metrics import compute_psnr

    mu = np.abs(np.asarray(b_h, np.float64)).mean()
    assert np.abs(b_h - b_p).mean() / mu < 1e-3
    assert np.abs(d_h - d_p).mean() / mu < 1e-3
    assert abs(compute_psnr(b_h, clean) - compute_psnr(b_p, clean)) < 0.03
    assert abs(compute_psnr(d_h, clean) - compute_psnr(d_p, clean)) < 0.03


def test_pipelined_single_chunk():
    """Degenerate one-chunk video still works (lag > n_chunks)."""
    sigma = 20.0
    clean = synthetic_video(4, 36, 40, seed=2)
    noisy = add_noise(clean, sigma, seed=3)
    cfg = _small_cfg(sigma)

    d_s, b_s, _ = denoise_streaming(noisy, sigma, chunk=8, cfg=cfg)
    d_p, b_p, _ = denoise_pipelined(noisy, sigma, chunk=8, cfg=cfg)
    np.testing.assert_array_equal(b_p, b_s)
    np.testing.assert_array_equal(d_p, d_s)


@pytest.mark.slow
def test_pipelined_halo_production_shape():
    """PP x halo-SP at a PRODUCTION-LIKE shape: the 8-device scale-out
    config had only ever compiled at 56-px toys, and
    shard_map has miscompiled once in this repo (ops/agg.py fold note).
    (T=6, C=3, H=480, W=256), full iphone preset window/K, production
    stride 6, 2 pipeline stages x 4 H-strips on the 8-device CPU mesh —
    compile + run end-to-end, sanity-check output (finite, denoises)."""
    import time

    import jax

    from vnlb_tpu.parallel.tiled import make_mesh
    from vnlb_tpu.utils.metrics import compute_psnr

    sigma = 20.0
    clean = synthetic_video(6, 480, 256, seed=7)
    noisy = add_noise(clean, sigma, seed=8)
    cfg = default_config(sigma, preset="iphone", eig_method="poly",
                         step_s=6, border_mode=["mask", "mask"])

    devs = jax.devices()
    assert len(devs) >= 8, "conftest provisions an 8-device CPU mesh"
    m1 = make_mesh(axis="h", devices=devs[:4])
    m2 = make_mesh(axis="h", devices=devs[4:8])

    t0 = time.perf_counter()
    deno, basic, _ = denoise_pipelined(noisy, sigma, chunk=6, cfg=cfg,
                                       meshes=(m1, m2))
    wall = time.perf_counter() - t0
    print(f"\n[pp-sp-prod] (6,3,480,256) 2x4 mesh wall {wall:.1f}s")
    assert deno.shape == noisy.shape
    assert np.isfinite(np.asarray(deno)).all()
    p_noisy = compute_psnr(noisy, clean)
    p_deno = compute_psnr(np.asarray(deno), clean)
    assert p_deno > p_noisy + 4.0, (p_noisy, p_deno)
