"""Strided-query layouts (ops/lattice_layout) and the in-scan selection of
ops/search_dense._level_dense.

The strided search keeps, inside each per-offset scan step, only the
distances at lattice slots.  That must equal selecting the same slots from
the stored all-pixels planes afterwards — bitwise, since the arithmetic is
the same and only the point of selection moves.  The planners must give
every lattice site its own slot holding that site's own dense position.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from vnlb_tpu.config import default_config
from vnlb_tpu.ops.lattice_layout import (coarse_plan, site_rows_coarse,
                                         site_rows_smat, site_rows_smat_tile,
                                         smat_sel_indices, tile_sel_indices)
from vnlb_tpu.ops.mask import lattice_sites
from vnlb_tpu.ops.search import _avg_pool2
from vnlb_tpu.ops.search_dense import _level_dense, _site_rows
from vnlb_tpu.testing.parity import lattice_phases

T, H, W = 3, 88, 92          # level-2 coarse frames (22 x 23) still fit


def _cfg(step, pt):
    return default_config(20.0, preset="iphone").stage(0).replace(
        step_s=step, pt=pt, nwt_b=1, nwt_f=1, border_mode="mask")


def _video(seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (T, 3, H, W)).astype(np.float32)


def _tile_geometry(cfg):
    """An interior strip [32, 56) of the frame with its halo rows."""
    halo = (cfg.w_s - 1) // 2 + cfg.ps - 1
    r0, hs = 32, 24
    return r0, hs, r0 - halo, r0 + hs + halo


def _layout(kind, cfg, shape):
    """(level video transform, sel (F, R, C), site rows, expected dense
    position of every site) for one kind of strided level."""
    t, _, h, w = shape
    ps, step = cfg.ps, cfg.step_s
    hp0, wp0 = h - ps + 1, w - ps + 1
    qrow0 = lattice_phases(shape, cfg)
    sites = lattice_sites(shape, cfg)
    s = jnp.asarray(sites)
    if kind == "level0":
        sel = smat_sel_indices(qrow0, hp0, wp0, step)
        rows = site_rows_smat(s, qrow0, step, hp0, wp0)
        want = sites[:, 0] * hp0 * wp0 + sites[:, 1] * wp0 + sites[:, 2]
        return (lambda v: v), sel, rows, want
    if kind.startswith("coarse"):
        lvl = int(kind[-1])
        h_l, w_l = h >> lvl, w >> lvl
        plan = coarse_plan(qrow0, lvl, hp0, wp0, h_l, w_l, ps, cfg.w_s, step)
        want = _site_rows(s, 1 << lvl, h_l - ps + 1, w_l - ps + 1, h_l, w_l,
                          ps, (cfg.w_s - 1) // 2)

        def pool(v):
            for _ in range(lvl):
                v = _avg_pool2(v)
            return v
        return pool, plan["sel"], site_rows_coarse(s, plan), np.asarray(want)
    r0, hs, y0, y1 = _tile_geometry(cfg)
    hp_t = (y1 - y0) - ps + 1
    home = (sites[:, 1] >= r0) & (sites[:, 1] < r0 + hs)
    s_g = sites[home]
    s_l = s_g.copy()
    s_l[:, 1] -= y0
    sel = tile_sel_indices(qrow0, jnp.int32(y0), hp_t, hp0, wp0, step)
    rows = site_rows_smat_tile(jnp.asarray(s_l), jnp.asarray(s_g[:, 1]),
                               qrow0, step, hp_t, hp0, wp0)
    want = s_l[:, 0] * hp_t * wp0 + s_l[:, 1] * wp0 + s_l[:, 2]
    return (lambda v: v[:, :, y0:y1]), np.asarray(sel), rows, want


KINDS = ["level0", "coarse1", "coarse2", "tile"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("step", [3, 6])
@pytest.mark.parametrize("pt", [1, 2])
def test_in_scan_selection_matches_post_hoc_take(kind, step, pt):
    """In-scan lattice selection == the full planes' post-hoc take."""
    cfg = _cfg(step, pt)
    video = _video(step + pt)
    level, sel, _, _ = _layout(kind, cfg, video.shape)
    v = level(jnp.asarray(video))
    dt = 1
    full = np.asarray(_level_dense(v, cfg)(dt))          # (ws2, F, H', W')
    post = full.reshape(full.shape[0], -1)[:, sel.reshape(-1)]
    got = np.asarray(_level_dense(v, cfg, jnp.asarray(sel.reshape(-1)))(dt))
    np.testing.assert_array_equal(got, post)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("step", [3, 6])
def test_planner_slots_hold_each_site(kind, step):
    """Each lattice site's slot holds its own dense plane position, and
    distinct sites get distinct slots wherever their positions differ
    (coarse levels merge sites that clamp to one coarse position)."""
    cfg = _cfg(step, 1)
    _, sel, rows, want = _layout(kind, cfg, (T, 3, H, W))
    rows = np.asarray(rows)
    assert rows.min() >= 0 and rows.max() < sel.size
    np.testing.assert_array_equal(sel.reshape(-1)[rows], want)
    pairs = set(zip(rows.tolist(), np.asarray(want).tolist()))
    assert len({r for r, _ in pairs}) == len(pairs)
