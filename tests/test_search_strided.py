"""Strided-query dense search: matches the all-pixels dense path.

The coverage lattice queries only ~1/step_s of rows AND columns, so the
strided path (ops/search_dense with ``qrow0``) keeps candidate distances
ONLY at lattice positions (ops/lattice_layout).  The selection happens
inside the per-offset scan on the same values, so values and indices are
pinned BIT-equal to the all-pixels path.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from vnlb_tpu.config import default_config
from vnlb_tpu.ops.mask import lattice_sites
from vnlb_tpu.ops.search_dense import exec_search_dense


def _phases(shape, cfg, t_origin=0):
    end_t = shape[0] - cfg.pt + 1
    return tuple(((f + t_origin) % cfg.step_s) if f < end_t - 1 else 0
                 for f in range(end_t))


def _mk(seed, t=4, h=48, w=52):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (t, 3, h, w)).astype(np.float32)


@pytest.mark.parametrize("step,stype", [(0, "l2"), (1, "l2"), (0, "needle")])
def test_strided_matches_full_xla(step, stype):
    video = _mk(3 + step)
    cfg = default_config(20.0, preset="iphone").stage(step).replace(
        nwt_b=2, nwt_f=2, npatches=20, stype=stype, border_mode="mask")
    sites = lattice_sites(video.shape, cfg)
    v, s = jnp.asarray(video), jnp.asarray(sites)
    fv, fi = exec_search_dense(v, s, cfg.replace(dense_rows="full"))
    sv, si = exec_search_dense(v, s, cfg, qrow0=_phases(video.shape, cfg))
    np.testing.assert_array_equal(np.asarray(sv), np.asarray(fv))
    np.testing.assert_array_equal(np.asarray(si), np.asarray(fi))


def _tie_aware_match(va, ia, vb, ib, vtol, tie):
    """Values agree to vtol; where top-K indices differ the two values must
    be a tie within ``tie`` (near-equal candidates may swap when the two
    formulations round differently)."""
    np.testing.assert_allclose(va, vb, atol=vtol, rtol=0)
    diff = ia != ib
    if diff.any():
        assert np.abs(va[diff] - vb[diff]).max() <= tie, (
            np.abs(va[diff] - vb[diff]).max())


@pytest.mark.parametrize("step,stype", [(0, "l2"), (0, "needle")])
def test_tile_search_whole_frame_matches(step, stype):
    """The halo-tile production search (traced row selection,
    ops/search_dense.exec_search_dense_tile) degenerates to the global
    strided path when the 'tile' is the whole frame (base_row=0).  The two
    graphs fuse differently under XLA:CPU, so values carry ~1e-8 noise
    (not bit-equal); indices may swap only at value ties."""
    from vnlb_tpu.ops.search_dense import exec_search_dense_tile

    video = _mk(7 + step)
    cfg = default_config(20.0, preset="iphone").stage(step).replace(
        nwt_b=2, nwt_f=2, npatches=20, stype=stype, border_mode="mask")
    qrow0 = _phases(video.shape, cfg)
    sites = lattice_sites(video.shape, cfg)
    v, s = jnp.asarray(video), jnp.asarray(sites)
    gv, gi = exec_search_dense(v, s, cfg, qrow0=qrow0)

    # coarse pyramid (full frames) exactly as the halo path gathers them
    coarse = []
    if stype == "needle":
        from vnlb_tpu.ops.search import _avg_pool2
        r = cfg.w_s + cfg.ps - 1
        cur = v
        for _ in range(1, cfg.needle_scales):
            cur = _avg_pool2(cur)
            if cur.shape[2] < r or cur.shape[3] < r:
                break
            coarse.append(cur)
    hp_g = video.shape[2] - cfg.ps + 1
    tv, ti = exec_search_dense_tile(v, s, s[:, 1], cfg, qrow0,
                                    jnp.int32(0), hp_g, tuple(coarse))
    _tie_aware_match(np.asarray(tv), np.asarray(ti),
                     np.asarray(gv), np.asarray(gi), vtol=1e-6, tie=1e-6)


def test_tile_search_offset_strip():
    """A true sub-strip tile (nonzero base_row, halo rows) returns the same
    candidates as the whole-frame search for every home-strip site, up to
    the tile-local index offset: decode both to GLOBAL (t, y, x).  The
    tile-local box-sum cumsums round differently from the full-frame ones
    (the documented halo seam effect, parallel/halo.py docstring), so
    values agree only to ~1e-3 and index disagreements must be value
    ties."""
    from vnlb_tpu.ops.search_dense import exec_search_dense_tile

    t, c, h, w = 4, 3, 72, 52
    video = _mk(13, t=t, h=h, w=w)
    cfg = default_config(20.0, preset="iphone").stage(0).replace(
        nwt_b=2, nwt_f=2, npatches=16, stype="l2", border_mode="mask")
    qrow0 = _phases(video.shape, cfg)
    halo = (cfg.w_s - 1) // 2 + cfg.ps - 1
    hs = 24
    r0 = 24                                  # strip [24, 48)
    base_row = r0 - halo
    tile = video[:, :, base_row:r0 + hs + halo, :]

    sites = lattice_sites(video.shape, cfg)
    sel = (sites[:, 1] >= r0) & (sites[:, 1] < r0 + hs)
    s_g = sites[sel]
    s_l = s_g.copy()
    s_l[:, 1] = s_g[:, 1] - base_row

    v = jnp.asarray(video)
    gv, gi = exec_search_dense(v, jnp.asarray(s_g), cfg, qrow0=qrow0)
    hp_g = h - cfg.ps + 1
    tv, ti = exec_search_dense_tile(jnp.asarray(tile), jnp.asarray(s_l),
                                    jnp.asarray(s_g[:, 1]), cfg, qrow0,
                                    jnp.int32(base_row), hp_g, ())

    # decode both index sets to a comparable global (t, y, x) key
    def dec(ii, hh, y_off):
        ii = np.asarray(ii).astype(np.int64)
        chw = c * hh * w
        f = ii // chw
        rem = ii % (hh * w)
        key = f * (10 ** 8) + (rem // w + y_off) * (10 ** 4) + rem % w
        return np.where(ii < 0, -1, key)
    g_key = dec(gi, h, 0)
    t_key = dec(ti, tile.shape[2], base_row)
    np.testing.assert_array_equal(g_key < 0, t_key < 0)
    _tie_aware_match(np.asarray(tv), t_key, np.asarray(gv), g_key,
                     vtol=2e-3, tie=2e-3)


def test_tile_search_offset_strip_needle():
    """Offset strip + NEEDLE mode: the coarse pyramid rides GLOBAL frames
    and global coordinates while level 0 runs in tile coordinates — the
    combination the halo mesh runs in stage 0 (neither covered by the
    whole-frame needle test nor the l2 offset test).  Same global-decode
    protocol as test_tile_search_offset_strip; coarse distances are
    bit-identical (shared full frames) so the tolerance stays the
    tile-cumsum 2e-3."""
    from vnlb_tpu.ops.search import _avg_pool2
    from vnlb_tpu.ops.search_dense import exec_search_dense_tile

    t, c, h, w = 4, 3, 96, 64
    video = _mk(17, t=t, h=h, w=w)
    cfg = default_config(20.0, preset="iphone").stage(0).replace(
        nwt_b=2, nwt_f=2, npatches=16, stype="needle", border_mode="mask")
    qrow0 = _phases(video.shape, cfg)
    halo0 = (cfg.w_s - 1) // 2 + cfg.ps - 1
    halo = halo0 + (halo0 % 2)              # parallel/halo._halo_rows
    hs = 24
    r0 = 48                                  # strip [48, 72)
    base_row = r0 - halo
    tile = video[:, :, base_row:r0 + hs + halo, :]

    sites = lattice_sites(video.shape, cfg)
    sel = (sites[:, 1] >= r0) & (sites[:, 1] < r0 + hs)
    s_g = sites[sel]
    s_l = s_g.copy()
    s_l[:, 1] = s_g[:, 1] - base_row

    v = jnp.asarray(video)
    gv, gi = exec_search_dense(v, jnp.asarray(s_g), cfg, qrow0=qrow0)

    # coarse pyramid: FULL frames, as _coarse_full_levels reconstructs
    coarse = []
    r = cfg.w_s + cfg.ps - 1
    cur = v
    for _ in range(1, cfg.needle_scales):
        cur = _avg_pool2(cur)
        if cur.shape[2] < r or cur.shape[3] < r:
            break
        coarse.append(cur)
    assert coarse, "geometry must exercise >=1 coarse level"

    hp_g = h - cfg.ps + 1
    tv, ti = exec_search_dense_tile(jnp.asarray(tile), jnp.asarray(s_l),
                                    jnp.asarray(s_g[:, 1]), cfg, qrow0,
                                    jnp.int32(base_row), hp_g,
                                    tuple(coarse))

    def dec(ii, hh, y_off):
        ii = np.asarray(ii).astype(np.int64)
        chw = c * hh * w
        f = ii // chw
        rem = ii % (hh * w)
        key = f * (10 ** 8) + (rem // w + y_off) * (10 ** 4) + rem % w
        return np.where(ii < 0, -1, key)

    g_key = dec(gi, h, 0)
    t_key = dec(ti, tile.shape[2], base_row)
    np.testing.assert_array_equal(g_key < 0, t_key < 0)
    _tie_aware_match(np.asarray(tv), t_key, np.asarray(gv), g_key,
                     vtol=2e-3, tie=2e-3)


def test_strided_nonzero_phase_origin():
    """Chunked streaming passes t_origin: phases shift per frame."""
    video = _mk(11, t=4, h=46, w=46)
    cfg = default_config(20.0, preset="iphone").stage(0).replace(
        nwt_b=1, nwt_f=1, npatches=8, stype="l2", border_mode="mask")
    t_origin = 4
    sites = lattice_sites(video.shape, cfg, t_origin)
    v, s = jnp.asarray(video), jnp.asarray(sites)
    fv, fi = exec_search_dense(v, s, cfg.replace(dense_rows="full"))
    sv, si = exec_search_dense(v, s, cfg,
                               qrow0=_phases(video.shape, cfg, t_origin))
    np.testing.assert_array_equal(np.asarray(sv), np.asarray(fv))
    np.testing.assert_array_equal(np.asarray(si), np.asarray(fi))


def test_packed_poly_matches_unpacked():
    """2-groups-per-matrix block-diagonal packing of the econ filter
    changes nothing but op count."""
    from vnlb_tpu.ops.polyspec import poly_filter_econ

    rng = np.random.default_rng(0)
    g, k, p = 12, 100, 49
    base = rng.normal(size=(g, k, p)).astype(np.float32) * 5
    xc2 = jnp.asarray(base + rng.normal(size=(g, k, p)).astype(np.float32))
    xn2 = jnp.asarray(base + rng.normal(size=(g, k, p)).astype(np.float32))
    cfg = default_config(20.0, preset="iphone").stage(0)
    a = np.asarray(poly_filter_econ(xc2, xn2, cfg))
    b = np.asarray(poly_filter_econ(xc2, xn2,
                                    cfg.replace(poly_pack2=False)))
    # identical math up to bf16 storage rounding of reordered combines
    assert np.abs(a - b).max() / np.abs(b).max() < 5e-3
