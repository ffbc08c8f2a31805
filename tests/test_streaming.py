"""Temporal chunked streaming (api.denoise_streaming): interior-exact.

Each pass streams with context = 2*nwt + pt - 1 frames per side (site reach
nwt+pt-1 plus those sites' window reach), pass 1's basic is assembled on the
host before pass 2 streams, and chunk lattices are phase-anchored to global
frame indices — so every streamed output frame sees exactly the candidates,
patch groups and aggregation deposits of the monolithic run, up to
scatter-order fp rounding.  The clips here are LONGER than one context
window (t_len > chunk + 2*ctx), so multiple true sub-window chunks run and
the partial-context anchoring path is genuinely exercised.
"""

import numpy as np
import pytest

from vnlb_tpu.api import denoise, denoise_streaming
from vnlb_tpu.config import default_config
from vnlb_tpu.testing.data import add_noise, synthetic_video
from vnlb_tpu.utils.metrics import compute_psnr


@pytest.fixture(scope="module")
def clip():
    clean = synthetic_video(13, 48, 48, seed=7)
    noisy = add_noise(clean, 20.0, seed=8)
    return clean, noisy


def _small_cfg():
    # small temporal window: ctx = 2*nwt + pt - 1 = 2 (pass 1, pt=1) / 3
    # (pass 2, pt=2), so chunk=3 windows (7 / 9 frames) are strict
    # sub-windows of the 13-frame clip -> >= 2 true partial-context chunks
    return default_config(20.0, preset="iphone", nwt_f=[1, 1], nwt_b=[1, 1])


def test_streaming_matches_monolithic(clip):
    clean, noisy = clip
    cfg = _small_cfg()
    d_full, b_full, _ = denoise(noisy, 20.0, cfg=cfg)
    d_s, b_s, _ = denoise_streaming(noisy, 20.0, chunk=3, cfg=cfg)

    d_full, b_full = np.asarray(d_full), np.asarray(b_full)
    assert d_s.shape == noisy.shape
    # context + phase anchoring + assembled basic make every contributing
    # site identical to the monolithic run; the only difference left is
    # the fp rounding order of scatter-adds (site batches regroup per
    # chunk) — worst-pixel deltas of a few 1e-2 on the 255 scale (pass 2
    # re-centers on the pass-1 basic, which roughly doubles pass-1's
    # rounding), with the overwhelming majority of pixels bitwise equal
    # (mean pin below).  The worst-pixel bound is noise-calibrated: the
    # round-3 masked-packed filter chain moved the observed max from ~0.05
    # to ~0.074 (reciprocal-vs-divide ulp shifts near the spectral gate)
    # while the mean and PSNR pins stayed unchanged.
    assert np.abs(b_s - b_full).max() < 5e-2, np.abs(b_s - b_full).max()
    assert np.abs(d_s - d_full).max() < 1.2e-1, np.abs(d_s - d_full).max()
    assert np.abs(b_s - b_full).mean() < 1e-3, np.abs(b_s - b_full).mean()
    assert np.abs(d_s - d_full).mean() < 1e-3, np.abs(d_s - d_full).mean()
    assert abs(compute_psnr(d_s, clean) - compute_psnr(d_full, clean)) < 0.01


def test_streaming_single_chunk_degenerates(clip):
    _, noisy = clip
    cfg = _small_cfg()
    d_s, b_s, _ = denoise_streaming(noisy, 20.0, chunk=100, cfg=cfg)
    d_full, b_full, _ = denoise(noisy, 20.0, cfg=cfg)
    np.testing.assert_array_equal(d_s, np.asarray(d_full))
    np.testing.assert_array_equal(b_s, np.asarray(b_full))


def test_streaming_with_halo_mesh():
    """Chunked streaming combined with halo spatial sharding (the 1080p-
    class scale-out composition: time chunks x H strips x chips)."""
    from vnlb_tpu.parallel.tiled import make_mesh

    clean = synthetic_video(11, 56, 56, seed=9)
    noisy = add_noise(clean, 20.0, seed=10)
    cfg = default_config(20.0, preset="iphone", nwt_f=[1, 1], nwt_b=[1, 1],
                         border_mode=["mask", "mask"], bsize=[32, 32])
    mesh = make_mesh(2, axis="h")
    d_s, b_s, _ = denoise_streaming(noisy, 20.0, chunk=3, cfg=cfg, mesh=mesh)
    d_full, _, _ = denoise_streaming(noisy, 20.0, chunk=3, cfg=cfg)
    assert d_s.shape == noisy.shape
    assert np.all(np.isfinite(d_s))
    # sharded+streamed tracks unsharded+streamed (near-tie top-K swaps at
    # strip seams, see tests/test_halo.py)
    assert np.abs(d_s - d_full).max() < 0.5, np.abs(d_s - d_full).max()


@pytest.mark.slow
def test_streaming_halo_1080_geometry():
    """Chunk-lattice phase anchoring at the BASELINE scale-out GEOMETRY
    H=1080 (auto-padded to 1088), 8 strips,
    multiple true sub-window chunks.  Streamed+sharded must track
    monolithic+sharded on interior frames at the test_halo closeness bar
    (both ride proc_nl_halo; only the chunk windows differ, and the
    phase-anchored lattices make interior frames see identical sites)."""
    from vnlb_tpu.parallel.halo import proc_nl_halo
    from vnlb_tpu.parallel.tiled import make_mesh

    h, w, t = 1080, 32, 9
    clean = synthetic_video(t, h, w, seed=21)
    noisy = add_noise(clean, 20.0, seed=22)
    cfg = default_config(20.0, preset="iphone", nwt_f=[1, 1], nwt_b=[1, 1],
                         border_mode=["mask", "mask"], bsize=[64, 64],
                         step_s=9)
    mesh = make_mesh(8, axis="h")
    d_s, b_s, _ = denoise_streaming(noisy, 20.0, chunk=3, cfg=cfg,
                                    mesh=mesh)
    assert d_s.shape == noisy.shape and np.isfinite(d_s).all()

    zf = np.zeros((t, 2, h, w), np.float32)
    b_m = np.asarray(proc_nl_halo(noisy, None, zf, zf, cfg.stage(0), mesh))
    d_m = np.asarray(proc_nl_halo(noisy, b_m, zf, zf, cfg.stage(1), mesh))
    # interior frames (full context both sides): ctx = 2*nwt+pt-1 = 3
    assert np.abs(d_s[4:5] - d_m[4:5]).max() < 0.5
    assert np.abs(d_s[4:5] - d_m[4:5]).mean() < 0.02
