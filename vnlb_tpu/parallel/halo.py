"""Halo-tiled spatial sharding: the video volume is SPLIT across the mesh.

Site-DP sharding (parallel/tiled.py) replicates the whole video per chip —
it scales FLOPs but not memory.  This module shards the frame volume over
the H axis (SURVEY.md §5 long-context plan) so videos beyond one chip's HBM
fit a slice:

* each device holds one (T, C, H/n, W) strip of every image;
* **halo exchange**: one `lax.ppermute` per direction ships the
  ``halo = (w_s-1)//2 + ps - 1 (+ flow margin, rounded even)`` boundary
  rows (14 for the iphone preset at zero flow) from each neighbor, giving
  the local tile every row its sites' search windows and patch gathers
  can touch;
* needle-mode coarse pyramid levels are average-pooled per strip and
  `all_gather`-ed — a coarse level is 4^level smaller than the video, so
  replicating it costs <1/3 extra memory while keeping coarse distances
  bit-identical to the single-device run (no coarse seam approximation);
* sites are processed in their home strip (local coordinates); global
  border handling is ``border_mode='mask'`` semantics with per-device
  global bounds;
* after the local fold, the ``halo``-row accumulation margins that spilled
  past the strip are ppermute'd to their owning neighbor and added —
  overlap-add between neighbours — then weights normalize locally.

Exactness: the sharded output equals the single-device
``border_mode='mask'`` output up to near-tie top-K swaps — the tile-local
box-sum cumsums round differently from full-frame ones, so candidates with
near-equal distances can swap at the K boundary (pinned <0.5 gray levels
max / fp-noise mean by tests/test_halo.py on a multi-device CPU mesh);
needle-mode coarse distances use the gathered full coarse frames, adding
no extra seam approximation.

Nonzero optical flow is supported: the halo widens by the host-computed
worst-case vertical window drift (nwt * max|flow_v|), flows ride the same
halo exchange, and the flow-aware gather search runs per tile with the
GLOBAL frame bounds threaded into its window/trajectory clamps
(ops/search.py ``y_bounds``) — slide border semantics, matching the
single-device gather path.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..config import StageConfig, VnlbConfig, default_config
from ..ops import agg, color
from ..ops.mask import lattice_sites
from ..ops.search import _avg_pool2, eff_dt_range
from ..ops.search_dense import _level_dense, _site_rows
from ..pipeline import accumulate


def _halo_rows(cfg: StageConfig, flow_margin: int = 0) -> int:
    """Boundary rows each neighbor must ship.

    base = window half-span + patch extent; ``flow_margin`` covers the
    worst-case vertical drift of a flow-tracked window center
    (<= nwt * max|flow_v|, computed on the host).  Rounded up to EVEN so
    tile 2x-pooling (needle pyramid) stays parity-aligned with the global
    frame."""
    base = (cfg.w_s - 1) // 2 + cfg.ps - 1 + flow_margin
    return base + (base % 2)


def _exchange_halos(x: jnp.ndarray, halo: int, axis_name: str) -> jnp.ndarray:
    """(..., Hs, W) strip -> (..., Hs + 2*halo, W) local tile.

    Edge devices receive zeros (outside the global frame; masked OOB)."""
    n = lax.axis_size(axis_name)
    down = [(i, i + 1) for i in range(n - 1)]     # my bottom rows -> below
    up = [(i, i - 1) for i in range(1, n)]        # my top rows -> above
    top_halo = lax.ppermute(x[..., -halo:, :], axis_name, down)
    bot_halo = lax.ppermute(x[..., :halo, :], axis_name, up)
    return jnp.concatenate([top_halo, x, bot_halo], axis=-2)


def _fold_margins(img: jnp.ndarray, halo: int, axis_name: str) -> jnp.ndarray:
    """Overlap-add the halo margins of a folded local tile to the owning
    neighbor strips: (..., Hs + 2*halo, W) -> (..., Hs, W)."""
    n = lax.axis_size(axis_name)
    down = [(i, i + 1) for i in range(n - 1)]
    up = [(i, i - 1) for i in range(1, n)]
    # my top margin belongs to the neighbor above; theirs lands at the
    # BOTTOM of my strip (and vice versa)
    from_below = lax.ppermute(img[..., :halo, :], axis_name, up)
    from_above = lax.ppermute(img[..., -halo:, :], axis_name, down)
    core = img[..., halo:-halo, :]
    core = core.at[..., -halo:, :].add(from_below)
    core = core.at[..., :halo, :].add(from_above)
    return core


def _search_dense_halo(tile, coarse_videos, sites_local, sites_global_y,
                       cfg: StageConfig, y_lo, y_hi):
    """Dense zero-flow top-K search on a halo'd strip tile.

    tile: (T, C, Hs + 2*halo, W) local video tile (YUV).
    coarse_videos: tuple of FULL-frame coarse pyramid levels (needle mode).
    sites_local: (S, 3) sites in tile coordinates.
    sites_global_y: (S,) global y of each site (for coarse-level anchors
      and OOB masking).
    y_lo / y_hi: traced scalars — valid GLOBAL candidate-corner y range
      expressed in TILE coordinates (for the +inf OOB mask).

    Returns (vals, inds) with inds in TILE flat coordinates
    (t*(C*Ht*W) + y_tile*W + x) — the downstream gathers and scatters all
    run in tile space.
    """
    t_len, c_full, ht, w = tile.shape
    k = cfg.npatches
    ps, pt, w_s = cfg.ps, cfg.pt, cfg.w_s
    half = (w_s - 1) // 2
    s_cnt = sites_local.shape[0]
    norm = float(cfg.pt * cfg.dist_chnls * cfg.ps * cfg.ps) * 255.0 ** 2

    videos = [tile] + list(coarse_videos)
    per_dt_fns = [_level_dense(v, cfg) for v in videos]

    ts = sites_local[:, 0]
    ys = sites_local[:, 1]
    xs = sites_local[:, 2]
    chw = c_full * ht * w

    dt_lo, dt_hi = eff_dt_range(cfg, t_len)

    # OOB mask (global bounds in tile coordinates for y, static for x)
    dgrid = jnp.arange(w_s, dtype=jnp.int32)
    cy_all = ys[:, None, None] - half + dgrid[None, :, None]
    cx_all = xs[:, None, None] - half + dgrid[None, None, :]
    oob = ((cy_all < y_lo) | (cy_all > y_hi)
           | (cx_all < 0) | (cx_all > w - ps))
    oob = oob.reshape(s_cnt, w_s * w_s)

    all_vals = []
    for dt in range(dt_lo, dt_hi + 1):
        cand = jnp.zeros((s_cnt, w_s * w_s), jnp.float32)
        for lvl, (v, fn) in enumerate(zip(videos, per_dt_fns)):
            d_all = fn(dt)                                  # (ws2, F, H', W')
            lh, lw = v.shape[2], v.shape[3]
            hp, wp = lh - ps + 1, lw - ps + 1
            if lvl == 0:
                rows = _site_rows(sites_local, 1, hp, wp, lh, lw, ps, half)
            else:
                # coarse levels are FULL frames: anchor at the global site
                sites_g = jnp.stack(
                    [ts, sites_global_y, xs], axis=1)
                rows = _site_rows(sites_g, 1 << lvl, hp, wp, lh, lw, ps,
                                  half)
            flat = jnp.transpose(d_all, (1, 2, 3, 0)).reshape(-1, w_s * w_s)
            cand = cand + jnp.take(flat, rows, axis=0) / norm

        f = ts + dt
        valid = (f >= 0) & (f <= t_len - pt)
        cand = jnp.where(valid[:, None], cand - cfg.offset, jnp.inf)
        cand = jnp.where(oob, jnp.inf, cand)
        all_vals.append(cand)

    from ..ops.search_dense import topk_planes
    vals, sel = topk_planes(all_vals, k)

    dt_i = sel // (w_s * w_s) + dt_lo
    rem = sel % (w_s * w_s)
    fcl = jnp.clip(ts[:, None] + dt_i, 0, t_len - pt)
    y = ys[:, None] - half + rem // w_s
    x = xs[:, None] - half + rem % w_s
    inds = fcl * chw + y * w + x
    inds = jnp.where(jnp.isinf(vals), -1, inds.astype(jnp.int32))
    from ..ops.search import _apply_tau

    return vals, _apply_tau(vals, inds, cfg)


def _plan_strip_sites(shape, cfg: StageConfig, n_dev: int, halo: int,
                      t_origin: int = 0):
    """Host-side: lattice sites partitioned by home strip, tile-local
    coordinates, padded to a common (NB, B) shape.

    Returns (site_batches (n, NB, B, 3), valid (n, NB, B),
             global_y (n, NB, B))."""
    t_len, c, h, w = shape
    hs = h // n_dev
    sites = lattice_sites(shape, cfg, t_origin)
    bsize = cfg.bsize

    per_dev = []
    for i in range(n_dev):
        r0 = i * hs
        sel = (sites[:, 1] >= r0) & (sites[:, 1] < r0 + hs)
        s = sites[sel].copy()
        gy = s[:, 1].copy()
        s[:, 1] = s[:, 1] - r0 + halo                       # tile coords
        per_dev.append((s, gy))

    nb = max(1, max(-(-d[0].shape[0] // bsize) for d in per_dev))
    sb = np.zeros((n_dev, nb, bsize, 3), np.int32)
    vb = np.zeros((n_dev, nb, bsize), bool)
    gy = np.zeros((n_dev, nb, bsize), np.int32)
    for i, (s, g) in enumerate(per_dev):
        cnt = s.shape[0]
        pad = nb * bsize - cnt
        filler = s[:1] if cnt else np.array([[0, halo, 0]], np.int32)
        gfill = g[:1] if cnt else np.array([halo], np.int32)
        s = np.concatenate([s, np.tile(filler, (pad, 1))])
        g = np.concatenate([g, np.tile(gfill, pad)])
        sb[i] = s.reshape(nb, bsize, 3)
        gy[i] = g.reshape(nb, bsize)
        vb[i] = (np.arange(nb * bsize) < cnt).reshape(nb, bsize)
    return sb, vb, gy


def _coarse_full_levels(strip, halo_cfg: StageConfig, axis_name: str):
    """Needle coarse pyramid: pool the strip, all_gather to full frames.

    Per-strip pooling reconstructs the GLOBAL pyramid level only while the
    strip height divides by 2 at every level (``_avg_pool2`` truncates odd
    rows, which would shift every seam); levels past an odd strip height
    are not built (``proc_nl_halo`` pads H so the full ``needle_scales``
    pyramid survives — this guard only matters for hand-built meshes)."""
    cfg = halo_cfg
    if cfg.stype != "needle":
        return ()
    r = cfg.w_s + cfg.ps - 1
    levels = []
    cur_strip = strip
    for _ in range(1, cfg.needle_scales):
        if cur_strip.shape[2] % 2:
            break                   # odd strip: pooled strips would misalign
        pooled = _avg_pool2(cur_strip)                      # (T, C, Hs/2^l, W/2^l)
        full = lax.all_gather(pooled, axis_name, axis=2, tiled=True)
        if full.shape[2] < r or full.shape[3] < r:
            break
        levels.append(full)
        cur_strip = pooled
    return tuple(levels)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "shape", "mesh", "n_dev", "halo",
                                    "use_flow", "qrow0"))
def _proc_nl_halo_jit(noisy, basic, fflow, bflow, site_batches,
                      valid_batches, gy_batches, cfg: StageConfig, shape,
                      mesh: Mesh, n_dev: int, halo: int, use_flow: bool,
                      qrow0=None):
    t_len, c, h, w = shape
    hs = h // n_dev
    cfgm = cfg.replace(border_mode="mask")

    noisy_yuv = color.rgb2yuv(noisy)
    basic_yuv = color.rgb2yuv(basic)

    def shard_fn(n_strip, b_strip, ff_strip, bf_strip, sb, vb, gyb):
        ax = "h"
        sb, vb, gyb = sb[0], vb[0], gyb[0]     # drop the size-1 device axis
        idx = lax.axis_index(ax)
        n_tile = _exchange_halos(n_strip, halo, ax)
        b_tile = _exchange_halos(b_strip, halo, ax)
        srch_tile = b_tile if cfg.srch_img == "basic" else n_tile
        srch_strip = b_strip if cfg.srch_img == "basic" else n_strip
        tile_shape = (t_len, c, hs + 2 * halo, w)

        # valid GLOBAL candidate rows, in tile coordinates: global row g is
        # tile row g - (idx*hs - halo); valid g in [0, H - ps]
        y_lo = jnp.int32(0) - (idx * hs - halo)
        y_hi = jnp.int32(h - cfg.ps) - (idx * hs - halo)

        if use_flow:
            # flow-aware gather search on the tile: flows ride the same
            # halo exchange; the GLOBAL frame bounds enter the window/
            # trajectory clamps as tile-coordinate y_bounds (slide border
            # semantics, identical to the single-device gather path).
            # Needle coarse levels use all_gather'ed FULL frames in global
            # coordinates (coarse windows span 2^lvl x the fine halo).
            from ..ops.search import x_im2col

            ff_tile = _exchange_halos(ff_strip, halo, ax)
            bf_tile = _exchange_halos(bf_strip, halo, ax)
            y_img_hi = jnp.int32(h - 1) - (idx * hs - halo)
            coarse = _coarse_full_levels(srch_strip, cfg, ax)
            r = cfg.w_s + cfg.ps - 1
            videos = (srch_tile,) + coarse
            xcols = tuple(x_im2col(v[:, :cfg.dist_chnls], r) for v in videos)
            deno_img, wts_img = accumulate(
                n_tile, b_tile, srch_tile, ff_tile, bf_tile, sb, vb, cfg,
                tile_shape, axis_name=ax, n_dense_batches=0,
                y_bounds=(y_lo, y_img_hi), search_ctx=(videos, xcols),
                coarse_global=cfg.stype == "needle")
        else:
            coarse = _coarse_full_levels(srch_strip, cfgm, ax)
            base_row = idx * hs - halo      # global row of tile row 0

            if qrow0 is not None:
                # PRODUCTION path: strided-query search + chunked one-take
                # on the tile — the same search the single-device pipeline
                # runs, with the lattice selection built per device from
                # the traced base_row
                from ..ops.search_dense import exec_search_dense_tile

                def dense_fn(srch, dense_sites):
                    s_flat = dense_sites.reshape(-1, 3)
                    gy_flat = gyb.reshape(-1)
                    return exec_search_dense_tile(
                        srch, s_flat, gy_flat, cfgm, qrow0, base_row,
                        h - cfg.ps + 1, coarse)
            else:
                # legacy all-rows fallback (topk="stream" low-memory mode /
                # dense_rows="full" verification)
                def dense_fn(srch, dense_sites):
                    s_flat = dense_sites.reshape(-1, 3)
                    gy_flat = gyb.reshape(-1)
                    return _search_dense_halo(srch, coarse, s_flat, gy_flat,
                                              cfgm, y_lo, y_hi)

            deno_img, wts_img = accumulate(
                n_tile, b_tile, srch_tile, None, None, sb, vb, cfgm,
                tile_shape, axis_name=ax, n_dense_batches=sb.shape[0],
                dense_search_fn=dense_fn)

        deno_img = _fold_margins(deno_img, halo, ax)
        wts_img = _fold_margins(wts_img[:, None], halo, ax)[:, 0]

        fallback = (b_strip if cfg.step == 1 else n_strip)
        fb_yuv = fallback
        out = agg.finalize_img(deno_img, wts_img, fb_yuv)
        return out

    out_yuv = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(None, None, "h", None), P(None, None, "h", None),
                  P(None, None, "h", None), P(None, None, "h", None),
                  P("h"), P("h"), P("h")),
        out_specs=P(None, None, "h", None),
    )(noisy_yuv, basic_yuv, fflow, bflow, site_batches, valid_batches,
      gy_batches)
    return color.yuv2rgb(out_yuv)


def proc_nl_halo(noisy, basic, fflow, bflow, cfg: StageConfig, mesh: Mesh,
                 t_origin: int = 0) -> jnp.ndarray:
    """One VNLB pass with the video sharded over H (halo exchange).

    Nonzero flows are supported: the halo widens by the worst-case vertical
    window drift (nwt * max|flow_v|, host-computed) and the flow-aware
    gather search runs per tile with global-bound clamps (slide border
    semantics); zero flow takes the dense shared-candidate fast path with
    masked borders.

    When H does not split into valid strips (even height, >= halo rows, and
    divisible by 2^(needle_scales-1) so per-strip needle pooling stays
    seam-aligned — e.g. 1080p on 8 devices: 1080/8 = 135,
    odd), the video is edge-padded at the bottom to the nearest valid
    multiple, processed, and the output cropped back.  Pad-row sites only
    touch output rows within one patch of the original bottom edge.
    """
    from ..utils.index import check_codec_range

    noisy_np = np.asarray(noisy, np.float32)
    shape = tuple(int(s) for s in noisy_np.shape)
    check_codec_range(shape)
    basic_np = noisy_np if basic is None else np.asarray(basic, np.float32)
    fflow_np = np.asarray(fflow, np.float32)
    bflow_np = np.asarray(bflow, np.float32)
    use_flow = bool(np.any(fflow_np) or np.any(bflow_np))

    n_dev = mesh.devices.size
    t_len, c, h, w = shape
    margin = 0
    if use_flow:
        nwt = max(cfg.nwt_b, cfg.nwt_f)
        mv = max(float(np.abs(fflow_np[:, 1]).max()),
                 float(np.abs(bflow_np[:, 1]).max()))
        margin = int(np.ceil(nwt * mv))
    halo = _halo_rows(cfg, margin)

    if h // n_dev < halo:
        raise ValueError(
            f"H={h} gives strips of {h // n_dev} rows < halo {halo} on "
            f"{n_dev} devices (halo includes flow margin {margin}); use "
            f"fewer devices or a taller video")

    _, hs, h_run = _strip_geometry(shape, cfg, n_dev, margin)
    if h_run != h:
        pad = h_run - h
        noisy_np = np.pad(noisy_np, ((0, 0), (0, 0), (0, pad), (0, 0)),
                          mode="edge")
        basic_np = np.pad(basic_np, ((0, 0), (0, 0), (0, pad), (0, 0)),
                          mode="edge")
        fflow_np = np.pad(fflow_np, ((0, 0), (0, 0), (0, pad), (0, 0)),
                          mode="edge")
        bflow_np = np.pad(bflow_np, ((0, 0), (0, 0), (0, pad), (0, 0)),
                          mode="edge")
        shape = (t_len, c, h_run, w)

    sb, vb, gy = _plan_strip_sites(shape, cfg, n_dev, halo, t_origin)
    # global lattice phases -> the production strided-query search on
    # each tile (same computation as pipeline.proc_nl); the legacy all-rows
    # path remains for the low-memory streaming top-K and verification modes
    qrow0 = None
    if not use_flow and cfg.dense_rows != "full" and cfg.topk == "exact":
        end_t = t_len - cfg.pt + 1
        qrow0 = tuple(((f + t_origin) % cfg.step_s) if f < end_t - 1 else 0
                      for f in range(end_t))
    out = _proc_nl_halo_jit(jnp.asarray(noisy_np), jnp.asarray(basic_np),
                            jnp.asarray(fflow_np), jnp.asarray(bflow_np),
                            jnp.asarray(sb), jnp.asarray(vb),
                            jnp.asarray(gy), cfg, shape,
                            mesh, n_dev, halo, use_flow, qrow0)
    return out[:, :, :h, :] if h_run != h else out


def _strip_geometry(shape, cfg: StageConfig, n_dev: int, margin: int = 0):
    """``proc_nl_halo``'s strip/padding rule (the ONLY copy — the mesh
    entry point and the shard_map-free ``strip_runner`` both call this, so
    their geometries cannot drift).

    Strip-height requirement: even (tile 2x-pooling parity) and, in needle
    mode, divisible by 2^l for every coarse level l that the global
    pyramid actually builds — per-strip pooling of an odd strip truncates
    rows and shifts every seam.

    Returns (halo, hs, h_run)."""
    _, _, h, w = shape
    halo = _halo_rows(cfg, margin)
    mult = 2
    if cfg.stype == "needle":
        r = cfg.w_s + cfg.ps - 1
        for lvl in range(1, cfg.needle_scales):
            if (h >> lvl) >= r and (w >> lvl) >= r:
                mult = max(mult, 2 ** lvl)

    def _rup(x, m):
        return -(-x // m) * m

    hs = max(_rup(-(-h // n_dev), mult), _rup(halo, mult))
    return halo, hs, hs * n_dev


def _coarse_full_single(srch_full: jnp.ndarray, cfg: StageConfig,
                        hs: int):
    """Shard_map-free twin of ``_coarse_full_levels``: the coarse pyramid
    one device ends up holding after the per-strip pool + all_gather, built
    by pooling the FULL frame (bit-identical when every strip pools evenly).

    Mirrors the mesh's level gating EXACTLY: a level is built while the
    per-strip height still halves evenly (width parity is irrelevant —
    ``_avg_pool2`` truncates odd widths identically for strips and full
    frames) and the pooled full frame still fits a search region.  A
    width-parity break here once dropped the 480p level-2 coarse work from
    the benched graph (caught by review; pinned by the W=86 case of
    tests/test_halo.py::test_strip_single_matches_mesh)."""
    if cfg.stype != "needle":
        return ()
    r = cfg.w_s + cfg.ps - 1
    levels = []
    cur_hs = hs
    cur = srch_full
    for _ in range(1, cfg.needle_scales):
        if cur_hs % 2:
            break
        cur_hs //= 2
        cur = _avg_pool2(cur)
        if cur.shape[2] < r or cur.shape[3] < r:
            break
        levels.append(cur)
    return tuple(levels)


@functools.partial(jax.jit, static_argnames=("cfg", "tile_shape", "hp_g",
                                             "qrow0"))
def _strip_tile_jit(n_tile, b_tile, sb, vb, gyb, base_row, coarse,
                    cfg: StageConfig, tile_shape, hp_g: int, qrow0):
    """One device's tile computation of the halo-SP mesh program, callable
    OUTSIDE shard_map: the same ``accumulate`` + ``exec_search_dense_tile``
    graph as ``shard_fn`` (zero-flow production path), with the halos and
    the gathered coarse pyramid pre-supplied as inputs and ``base_row``
    traced exactly as the mesh's ``axis_index``-derived scalar is.

    Returns the FOLDED tile accumulators (deno_img, wts_img) over the full
    tile (home strip + halo margins), i.e. the state just before the
    mesh's ppermute overlap-add — so a host-side combiner can reproduce
    the mesh output exactly (tests/test_halo.py) and a single card can
    time the true per-shard wall."""
    from ..ops.search_dense import exec_search_dense_tile

    cfgm = cfg.replace(border_mode="mask")
    srch_tile = b_tile if cfg.srch_img == "basic" else n_tile

    if qrow0 is not None:
        def dense_fn(srch, dense_sites):
            s_flat = dense_sites.reshape(-1, 3)
            gy_flat = gyb.reshape(-1)
            return exec_search_dense_tile(srch, s_flat, gy_flat, cfgm,
                                          qrow0, base_row, hp_g, coarse)
    else:
        # legacy all-rows path — mirrors shard_fn's gate (topk='stream'
        # low-memory mode / dense_rows='full' verification)
        y_lo = -base_row
        y_hi = jnp.int32(hp_g - 1) - base_row

        def dense_fn(srch, dense_sites):
            s_flat = dense_sites.reshape(-1, 3)
            gy_flat = gyb.reshape(-1)
            return _search_dense_halo(srch, coarse, s_flat, gy_flat,
                                      cfgm, y_lo, y_hi)

    return accumulate(n_tile, b_tile, srch_tile, None, None, sb, vb, cfgm,
                      tile_shape, axis_name=None,
                      n_dense_batches=sb.shape[0], dense_search_fn=dense_fn)


def strip_runner(noisy, basic, cfg: StageConfig, n_dev: int,
                 strip_idx: int, t_origin: int = 0):
    """Build a reusable runner for ONE strip of the ``n_dev``-strip halo-SP
    mesh program on the current (single) device, shard_map-free — zero-flow
    production path.

    Pre-supplies what the mesh's collectives would deliver: the halo rows
    (sliced from the full video; zeros past the global frame, matching
    ``_exchange_halos`` on edge devices) and the needle coarse pyramid
    (pooled from the full frame — bit-identical to the all_gather of
    per-strip poolings since strips are even).  Everything else is the
    exact per-device graph of ``_proc_nl_halo_jit``.

    Returns (run, meta): ``run()`` executes the strip's tile computation on
    DEVICE-RESIDENT inputs and returns the pre-fold accumulators
    (deno_tile, wts_tile) over (T, C, hs + 2*halo, W).  Keeping the inputs
    resident matters for timing: in the real mesh the strips live on their
    devices across steps, so a timing must not re-pay host->device uploads
    per call.  ``combine_strips`` overlap-adds a full set of tiles into
    the mesh result."""
    noisy_np = np.asarray(noisy, np.float32)
    shape = tuple(int(s) for s in noisy_np.shape)
    basic_np = noisy_np if basic is None else np.asarray(basic, np.float32)
    t_len, c, h, w = shape
    halo, hs, h_run = _strip_geometry(shape, cfg, n_dev)
    if h_run != h:
        pad = h_run - h
        noisy_np = np.pad(noisy_np, ((0, 0), (0, 0), (0, pad), (0, 0)),
                          mode="edge")
        basic_np = np.pad(basic_np, ((0, 0), (0, 0), (0, pad), (0, 0)),
                          mode="edge")
        shape = (t_len, c, h_run, w)

    sb, vb, gy = _plan_strip_sites(shape, cfg, n_dev, halo, t_origin)
    # same production-path gate as proc_nl_halo: the legacy all-rows path
    # serves the low-memory streaming top-K and verification modes
    qrow0 = None
    if cfg.dense_rows != "full" and cfg.topk == "exact":
        end_t = t_len - cfg.pt + 1
        qrow0 = tuple(((f + t_origin) % cfg.step_s) if f < end_t - 1 else 0
                      for f in range(end_t))

    noisy_yuv = np.asarray(color.rgb2yuv(jnp.asarray(noisy_np)))
    basic_yuv = np.asarray(color.rgb2yuv(jnp.asarray(basic_np)))

    def tile_of(img):
        t0 = strip_idx * hs - halo
        tile = np.zeros(img.shape[:2] + (hs + 2 * halo, w), np.float32)
        lo, hi = max(t0, 0), min(t0 + hs + 2 * halo, h_run)
        tile[:, :, lo - t0:hi - t0] = img[:, :, lo:hi]
        return tile

    n_tile = jnp.asarray(tile_of(noisy_yuv))
    b_tile = jnp.asarray(tile_of(basic_yuv))
    srch_full = basic_yuv if cfg.srch_img == "basic" else noisy_yuv

    coarse = _coarse_full_single(jnp.asarray(srch_full),
                                 cfg.replace(border_mode="mask"), hs)

    tile_shape = (t_len, c, hs + 2 * halo, w)
    args = (n_tile, b_tile, jnp.asarray(sb[strip_idx]),
            jnp.asarray(vb[strip_idx]), jnp.asarray(gy[strip_idx]),
            jnp.int32(strip_idx * hs - halo), coarse)
    kw = dict(cfg=cfg, tile_shape=tile_shape, hp_g=h_run - cfg.ps + 1,
              qrow0=qrow0)
    jax.block_until_ready(args)
    meta = dict(halo=halo, hs=hs, h_run=h_run, h=h, shape=shape)

    def run():
        return _strip_tile_jit(*args, **kw)

    return run, meta


def proc_nl_strip_single(noisy, basic, cfg: StageConfig, n_dev: int,
                         strip_idx: int, t_origin: int = 0):
    """One-shot convenience wrapper over ``strip_runner`` (correctness
    tests); returns (deno_tile, wts_tile, meta)."""
    run, meta = strip_runner(noisy, basic, cfg, n_dev, strip_idx, t_origin)
    deno_t, wts_t = run()
    return deno_t, wts_t, meta


def combine_strips(tiles, cfg: StageConfig, noisy, basic, meta):
    """Host-side overlap-add of per-strip tile accumulators into the mesh
    result: the ppermute margin fold + finalize of ``shard_fn``, off
    device.  ``tiles`` = [(deno_tile, wts_tile)] for strips 0..n-1."""
    halo, hs, h_run, h = meta["halo"], meta["hs"], meta["h_run"], meta["h"]
    t_len, c, _, w = meta["shape"]
    n_dev = len(tiles)
    deno = np.zeros((t_len, c, h_run, w), np.float32)
    wts = np.zeros((t_len, h_run, w), np.float32)
    for i, (dt_, wt_) in enumerate(tiles):
        t0 = i * hs - halo
        lo, hi = max(t0, 0), min(t0 + hs + 2 * halo, h_run)
        deno[:, :, lo:hi] += np.asarray(dt_)[:, :, lo - t0:hi - t0]
        wts[:, lo:hi] += np.asarray(wt_)[:, lo - t0:hi - t0]

    noisy_yuv = np.asarray(color.rgb2yuv(jnp.asarray(
        np.pad(np.asarray(noisy, np.float32),
               ((0, 0), (0, 0), (0, h_run - h), (0, 0)), mode="edge"))))
    if basic is None:
        basic_yuv = noisy_yuv
    else:
        basic_yuv = np.asarray(color.rgb2yuv(jnp.asarray(
            np.pad(np.asarray(basic, np.float32),
                   ((0, 0), (0, 0), (0, h_run - h), (0, 0)), mode="edge"))))
    fallback = basic_yuv if cfg.step == 1 else noisy_yuv
    out_yuv = agg.finalize_img(jnp.asarray(deno), jnp.asarray(wts),
                               jnp.asarray(fallback))
    out = np.asarray(color.yuv2rgb(out_yuv))
    return out[:, :, :h]


def denoise_halo(noisy, sigma: float, mesh: Optional[Mesh] = None,
                 flows=None, preset: str = "iphone",
                 cfg: Optional[VnlbConfig] = None
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Two-pass VNLB with the frame volume sharded across the mesh."""
    from ..api import _prep_flows
    from .tiled import make_mesh

    mesh = mesh or make_mesh(axis="h")
    cfg = cfg or default_config(sigma, preset=preset)
    fflow, bflow, _ = _prep_flows(noisy.shape, flows)
    basic = proc_nl_halo(noisy, None, fflow, bflow, cfg.stage(0), mesh)
    deno = proc_nl_halo(noisy, basic, fflow, bflow, cfg.stage(1), mesh)
    return deno, basic
