"""Halo-tiled spatial sharding tests (SURVEY.md §5 long-context plan).

The video volume is SPLIT over the mesh's H axis with `ppermute` halo
exchange; these tests pin tiled == untiled on the virtual 8-device CPU
mesh, for clips that exercise >= 2 halo seams.
"""

import jax
import numpy as np
import pytest

from vnlb_tpu.config import default_config
from vnlb_tpu.parallel.halo import denoise_halo, proc_nl_halo
from vnlb_tpu.parallel.tiled import make_mesh
from vnlb_tpu.pipeline import proc_nl
from vnlb_tpu.testing.data import add_noise, synthetic_video


@pytest.fixture(scope="module")
def clip():
    # H=56 splits into 4 strips of 14 rows (halo=13 for the iphone preset):
    # 3 interior seams, every strip narrower than the halo'd window.
    clean = synthetic_video(3, 56, 56, seed=5)
    noisy = add_noise(clean, 20.0, seed=6)
    zf = np.zeros((3, 2, 56, 56), np.float32)
    return noisy, zf


@pytest.mark.parametrize("ndev,stage", [(2, 0), (4, 0), (4, 1), (8, 0)])
def test_halo_matches_single_device(clip, ndev, stage):
    noisy, zf = clip
    cfg = default_config(20.0, preset="iphone").stage(stage)
    cfg = cfg.replace(border_mode="mask", bsize=32)
    if ndev == 8:
        # 8 strips of 7 rows < halo: must refuse loudly
        mesh = make_mesh(8, axis="h")
        with pytest.raises(ValueError, match="strip"):
            proc_nl_halo(noisy, None, zf, zf, cfg, mesh)
        return
    mesh = make_mesh(ndev, axis="h")
    cfg0 = default_config(20.0, preset="iphone").stage(0).replace(
        border_mode="mask", bsize=32)
    basic = None if stage == 0 else np.asarray(
        proc_nl(noisy, None, None, zf, zf, cfg0))
    got = np.asarray(proc_nl_halo(noisy, basic, zf, zf, cfg, mesh))
    want = np.asarray(proc_nl(noisy, basic, None, zf, zf, cfg))
    _assert_close(got, want)


def _assert_close(got, want):
    """Tiled == untiled up to near-tie top-K swaps: the tile-local box-sum
    cumsums round differently from the full-frame ones, so candidates with
    near-equal distances can swap at the K boundary.  Pin every pixel within
    half a gray level and the mean error at fp-noise scale."""
    np.testing.assert_array_less(np.abs(got - want).max(), 0.5)
    assert np.abs(got - want).mean() < 0.02, np.abs(got - want).mean()


def test_halo_two_pass(clip):
    noisy, _ = clip
    mesh = make_mesh(4, axis="h")
    cfg = default_config(20.0, preset="iphone", border_mode=["mask", "mask"],
                         bsize=[32, 32])
    deno, basic = denoise_halo(noisy, 20.0, mesh=mesh, cfg=cfg)
    assert np.asarray(deno).shape == noisy.shape
    assert np.all(np.isfinite(np.asarray(deno)))
    # sharded two-pass == single-device two-pass (mask border mode)
    zf = np.zeros((noisy.shape[0], 2) + noisy.shape[2:], np.float32)
    basic1 = proc_nl(noisy, None, None, zf, zf, cfg.stage(0))
    deno1 = proc_nl(noisy, basic1, None, zf, zf, cfg.stage(1))
    _assert_close(np.asarray(basic), np.asarray(basic1))
    _assert_close(np.asarray(deno), np.asarray(deno1))


def test_halo_memory_is_sharded(clip):
    """Each device holds ~1/n of the video strips (the point of this mode)."""
    noisy, zf = clip
    mesh = make_mesh(4, axis="h")
    cfg = default_config(20.0, preset="iphone").stage(0).replace(
        border_mode="mask", bsize=32)
    out = proc_nl_halo(noisy, None, zf, zf, cfg, mesh)
    out.block_until_ready()
    assert out.shape == noisy.shape


def test_halo_with_flow_matches_single_device(clip):
    """Flow-aware halo: nonzero flows widen the halo and route through the
    per-tile gather search with global-bound clamps (slide semantics) —
    must track the single-device flow-aware run."""
    noisy, _ = clip
    t, _, h, w = noisy.shape
    # smooth synthetic flow, |v| <= 1.2 -> margin = ceil(nwt * 1.2)
    yy = np.linspace(0, 2 * np.pi, h, dtype=np.float32)
    v = 1.2 * np.sin(yy)[None, None, :, None]
    fflow = np.zeros((t, 2, h, w), np.float32)
    bflow = np.zeros((t, 2, h, w), np.float32)
    fflow[:, 1:] = v
    bflow[:, 1:] = -v

    # small temporal window keeps the flow margin (and compile) small
    cfg = default_config(20.0, preset="iphone", nwt_f=[1, 1],
                         nwt_b=[1, 1]).stage(0).replace(bsize=32)
    mesh = make_mesh(2, axis="h")
    got = np.asarray(proc_nl_halo(noisy, None, fflow, bflow, cfg, mesh))
    want = np.asarray(proc_nl(noisy, None, None, fflow, bflow, cfg))
    _assert_close(got, want)


def test_halo_1080_row_autopad():
    """1080p on 8 devices: H=1080 does not split into 8 valid strips
    (1080/8 = 135, odd), so proc_nl_halo edge-pads to 1088 (8 strips of
    136), processes, and crops back (halo.py:384-404).

    Two pins:
      1. EXACT: the auto-pad path equals running the same halo mesh on a
         hand-edge-padded 1088-row video and cropping — the pad/crop wiring
         adds nothing beyond the pad itself.
      2. SEMANTIC: vs the unpadded single-device run the mean error stays
         at the near-tie-swap noise floor of the other halo pins (at this
         frame area the pointwise max is dominated by generic tile-cumsum
         tie swaps, not the pad — measured identical with and without
         padding — so the pointwise pin lives in the small-clip tests).

    Small W + coarse lattice + 1-frame temporal window keep the 8-device
    CPU-mesh runs tractable; the auto-pad math is identical at full size.
    """
    h, w = 1080, 32
    clean = synthetic_video(2, h, w, seed=11)
    noisy = add_noise(clean, 20.0, seed=12)
    zf = np.zeros((2, 2, h, w), np.float32)
    cfg = default_config(20.0, preset="iphone", nwt_f=[1, 1],
                         nwt_b=[1, 1]).stage(0).replace(
        border_mode="mask", bsize=64, step_s=9)

    mesh = make_mesh(8, axis="h")
    got = np.asarray(proc_nl_halo(noisy, None, zf, zf, cfg, mesh))
    assert got.shape == noisy.shape  # cropped back from the padded 1088

    # 1. exact equality with a hand-padded run (1088 = 8 strips of 136)
    pad = ((0, 0), (0, 0), (0, 8), (0, 0))
    noisy_p = np.pad(noisy, pad, mode="edge")
    zf_p = np.pad(zf, pad, mode="edge")
    manual = np.asarray(proc_nl_halo(noisy_p, None, zf_p, zf_p, cfg, mesh))
    np.testing.assert_array_equal(got, manual[:, :, :h])

    # 2. pad-semantics sanity vs the unpadded single-device run.  The pad
    # legitimately moves the always-on bottom-border lattice rows (from
    # end_h-1=1074 to 1082), so the last window+patch rows genuinely
    # differ; above that band the error must sit at the same near-tie-swap
    # noise floor as the no-pad halo runs.
    want = np.asarray(proc_nl(noisy, None, None, zf, zf, cfg))
    assert np.isfinite(got).all()
    band = (cfg.w_s - 1) // 2 + 2 * cfg.ps           # pad-affected rows
    diff = np.abs(got - want)
    assert diff[:, :, :-band].mean() < 0.03, diff[:, :, :-band].mean()
    assert diff[:, :, -band:].max() < 40.0, diff[:, :, -band:].max()


def test_fold_in_shardmap():
    """Regression: agg.fold must give identical results inside and outside
    shard_map.  jax 0.9.0's XLA:CPU miscompiles a
    ``weights.at[j:].add(box_full(wv)[:tl])`` dynamic-update-slice-add of a
    cumsum-derived operand inside shard_map (wrong weights on every tile,
    >100 gray levels of final error on the pt=2 stage); agg.fold uses a
    concat-shifted weight sum instead.  This pins the fixed form."""
    from jax.sharding import Mesh, PartitionSpec as P

    from vnlb_tpu.ops import agg

    ps, pt, t_len = 7, 2, 3
    h, w = 42, 56
    hp, wp = h - ps + 1, w - ps + 1
    d = 3 * ps * ps
    rng = np.random.default_rng(0)
    acc_all = rng.normal(
        size=(4, t_len * hp * wp, pt * d + 1)).astype(np.float32)
    acc_all[..., -1] = rng.integers(
        0, 5, size=acc_all.shape[:-1]).astype(np.float32)

    shape = (t_len, 3, h, w)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("d",))
    f = jax.jit(jax.shard_map(
        lambda a: tuple(x[None] for x in agg.fold(a[0], pt, ps, shape)),
        mesh=mesh, in_specs=(P("d"),), out_specs=(P("d"), P("d"))))
    deno_s, wts_s = f(acc_all)
    for i in range(4):
        deno_i, wts_i = agg.fold(acc_all[i], pt, ps, shape)
        np.testing.assert_array_equal(np.asarray(wts_s[i]), np.asarray(wts_i))
        np.testing.assert_allclose(np.asarray(deno_s[i]),
                                   np.asarray(deno_i), atol=1e-4)


@pytest.mark.parametrize("geom", ["small", "coarse2", "stream"])
def test_strip_single_matches_mesh(clip, geom):
    """The shard_map-free single-strip runner (proc_nl_strip_single +
    combine_strips) reproduces the mesh program's output — a per-shard
    wall timed on one card with it is therefore the wall of the code the
    mesh actually runs.

    geom='coarse2' uses (3, 88, 86): strips of 24 rows build TWO needle
    coarse levels with an ODD pooled width (43) — the shape class where a
    review caught strip_runner building fewer coarse levels than the mesh
    (a width-parity break the mesh does not have; 5.6-gray-level
    divergence before the fix, invisible at the 56x56 fixture).

    Tolerance: the two run the same per-tile graph, but XLA fuses the
    standalone jit differently from the shard_map body, so the bf16
    candidate planes round differently and near-tie top-K picks can swap
    (measured: max 0.11 gray levels on the small clip) — the same effect
    and the same pin as the seam tests (_assert_close), plus a tight mean.
    """
    from vnlb_tpu.parallel.halo import combine_strips, proc_nl_strip_single

    if geom == "small":
        noisy, zf = clip
    else:
        clean = synthetic_video(3, 88, 86, seed=15)
        noisy = add_noise(clean, 20.0, seed=16)
        zf = np.zeros((3, 2, 88, 86), np.float32)
    ndev = 4
    cfg = default_config(20.0, preset="iphone").stage(0).replace(
        border_mode="mask", bsize=32)
    if geom == "stream":
        # topk='stream' gates OFF the one-shot tile path in BOTH the mesh
        # and the runner (qrow0=None -> legacy all-rows search); the
        # runner must mirror that gate (review finding #4)
        cfg = cfg.replace(topk="stream")
    mesh = make_mesh(ndev, axis="h")
    want = np.asarray(proc_nl_halo(noisy, None, zf, zf, cfg, mesh))

    tiles, meta = [], None
    for i in range(ndev):
        dt_, wt_, meta = proc_nl_strip_single(noisy, None, cfg, ndev, i)
        tiles.append((dt_, wt_))
    got = combine_strips(tiles, cfg, noisy, None, meta)
    assert got.shape == want.shape
    _assert_close(got, want)
    assert np.abs(got - want).mean() < 5e-3, np.abs(got - want).mean()
