"""Dense zero-flow top-K search — the production fast path.

The gather-based search (ops/search.py) evaluates every (site, candidate)
pair independently: ~90 MB of region traffic per 256-site batch.  With zero
optical flow (the default `denoise()` path — the reference's effective
behavior too, SURVEY.md §3.1) the window of every *interior* site is a pure
translation: candidate = site + delta, delta in a fixed (n_dt, w_s, w_s)
offset grid.  Distances for ALL sites then share work across the frame:

    D(x, dt, delta) = q2(x) + b2[t+dt](x+delta) - 2 * cross_dt,delta(x)
    q2   = box_ps(sum_{f,c} V^2)                    (once per video)
    cross = box_ps(sum_{f,c} V[t+f] . V[t+dt+f](.+delta))   (one elementwise
            multiply + separable box filter per (dt, delta) — shared by
            every site in the frame)

per-offset cost is O(pixels), not O(sites * patch), an ~ps^2 = 49x FLOP
reduction over the per-site path.  Non-interior (border) sites — whose
window clamps — keep the exact gather path; the pipeline splits the site
list statically (ops/mask.interior_split).

Strided queries: when the caller passes the coverage-lattice phases
(``qrow0``), each per-offset scan step keeps only the distances at lattice
positions (ops/lattice_layout), so the stored candidate planes shrink by
~step_s^2 while the values stay bit-equal to the all-pixels planes.

Candidate enumeration order (dt asc, dy, dx) and the top-K merge order are
identical to ops/search.exec_search, so ties resolve identically and the
two paths return bit-equal results for interior sites (pinned by
tests/test_search_dense.py).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import StageConfig
from .lattice_layout import (coarse_plan, site_rows_coarse, site_rows_smat,
                             site_rows_smat_tile, smat_sel_indices,
                             tile_sel_indices)
from .search import _apply_tau, _avg_pool2, eff_dt_range

# Byte budget of one stacked chunk of candidate planes (see _level_parts).
# A fixed gate sized for the small device memory of the accelerator this
# pipeline was first written for: it only splits the row take (equal
# results) and is safe on an 80 GB card.  ROADMAP A7 derives it from the
# device's memory_stats()["bytes_limit"].
_CHUNK_BYTES = int(3e9)


def _box_ps(x, ps):
    """Separable ps x ps box sum, VALID: (..., H, W) -> (..., H', W')."""
    xr = jnp.cumsum(x, axis=-1)
    xr = jnp.concatenate([xr[..., ps - 1:ps], xr[..., ps:] - xr[..., :-ps]],
                         axis=-1)
    xc = jnp.cumsum(xr, axis=-2)
    xc = jnp.concatenate([xc[..., ps - 1:ps, :],
                          xc[..., ps:, :] - xc[..., :-ps, :]], axis=-2)
    return xc


def _level_dense(video, cfg: StageConfig, sel=None):
    """Per-level candidate distances, one temporal offset per call.

    Returns per_dt(dt) -> (w_s*w_s, F, H', W') float32 raw squared
    distances where F = T-pt+1 (rows for temporally-invalid dt contain
    garbage and are masked by the caller).  With ``sel`` (flat int32
    indices into the (F*H'*W')-flattened plane) each per-offset scan step
    keeps only those positions: per_dt(dt) -> (w_s*w_s, sel.size), the
    same values as selecting from the full planes afterwards, without
    ever storing them.
    """
    t_len, _, h, w = video.shape
    ps, pt, c_d, w_s = cfg.ps, cfg.pt, cfg.dist_chnls, cfg.w_s
    half = (w_s - 1) // 2
    f_cnt = t_len - pt + 1

    vc = video[:, :c_d]                                    # (T, c_d, H, W)
    v2 = jnp.sum(vc * vc, axis=1)                          # (T, H, W)
    v2p = sum(v2[f:f + f_cnt] for f in range(pt))          # (F, H, W)
    q2 = _box_ps(v2p, ps)                                  # (F, H', W')

    pad = ((0, 0), (half, half), (half, half))
    pad4 = ((0, 0), (0, 0), (half, half), (half, half))
    hp, wp = h - ps + 1, w - ps + 1

    def per_dt(dt):
        vd = jnp.roll(vc, -dt, axis=0)                     # V[t+dt] at row t
        vd_pad = jnp.pad(vd, pad4)                         # (T, c_d, H+, W+)
        b2d = jnp.roll(q2, -dt, axis=0)                    # (F, H', W')
        b2pad = jnp.pad(b2d, pad)

        def per_delta(_, didx):
            a = didx // w_s
            b = didx % w_s
            # shift ONE factor (frame t+dt) by delta, multiply, box-sum:
            # cross(x) = sum_{f,c,p} V[t+f](x+p) V[t+dt+f](x+delta+p)
            vds = lax.dynamic_slice(vd_pad, (0, 0, a, b),
                                    (t_len, c_d, h, w))
            prod_full = jnp.sum(vc * vds, axis=1)          # (T, H, W)
            prod_pt = sum(prod_full[f:f + f_cnt] for f in range(pt))
            cross = _box_ps(prod_pt, ps)                   # (F, H', W')
            b2s = lax.dynamic_slice(b2pad, (0, a, b), (f_cnt, hp, wp))
            d = q2 + b2s - 2.0 * cross
            if sel is not None:
                d = jnp.take(d.reshape(-1), sel, mode="clip")
            return None, d

        _, d_all = lax.scan(per_delta, None,
                            jnp.arange(w_s * w_s, dtype=jnp.int32))
        return d_all

    return per_dt


def _level(video, cfg: StageConfig, pdty, sel=None):
    """(per_dt, pos): per_dt(dt) -> (pos, w_s*w_s) candidate rows in
    ``pdty``, one row per query position — every pixel of the (F, H', W')
    plane, or the ``sel`` lattice slots in their layout order.

    bf16 planes (cfg.search_bf16): the cast fuses into the layout
    transpose, so the transpose write and the row take move half the
    bytes; values upcast to f32 right after the take."""
    ws2 = cfg.w_s * cfg.w_s
    if sel is None:
        fn = _level_dense(video, cfg)
        t_len, _, h, w = video.shape
        pos = (t_len - cfg.pt + 1) * (h - cfg.ps + 1) * (w - cfg.ps + 1)
        return (lambda dt: jnp.transpose(fn(dt).astype(pdty),
                                         (1, 2, 3, 0)).reshape(pos, ws2),
                pos)
    fn = _level_dense(video, cfg, sel.reshape(-1))
    return (lambda dt: fn(dt).astype(pdty).T), int(sel.size)


def _site_rows(sites, scale, hp, wp, h_lvl, w_lvl, ps, half):
    """Flat row index of each (possibly pyramid-scaled) site into
    (F, H', W')-flattened dense buffers.

    For coarse levels (scale > 1) the position is clamped into the
    clamp-free band [half, lvl_dim - ps - half]: the effective window then
    equals the gather path's sliding-clamped window, with the coarse query
    anchored at the clamped center (<= half-pixel coarse offset for sites
    near borders — an approximation on an additive coarse term only)."""
    t = sites[:, 0]
    lo = half if scale > 1 else 0
    y = jnp.clip(sites[:, 1] // scale, lo, max(h_lvl - ps - lo, 0))
    x = jnp.clip(sites[:, 2] // scale, lo, max(w_lvl - ps - lo, 0))
    return t * (hp * wp) + y * wp + x


def _coarse_levels(videos, cfg: StageConfig, qrow0, sites, hp0: int,
                   wp0: int, pdty):
    """[(per_dt, rows, pos)] of the strided coarse needle levels: the
    per-phase ``coarse_plan`` layout of each full-frame pyramid level,
    addressed by full-res lattice ``sites`` in global coordinates."""
    out = []
    for lvl, v_l in enumerate(videos, 1):
        plan = coarse_plan(qrow0, lvl, hp0, wp0, v_l.shape[2], v_l.shape[3],
                           cfg.ps, cfg.w_s, cfg.step_s)
        fn, pos = _level(v_l, cfg, pdty, jnp.asarray(plan["sel"]))
        out.append((fn, site_rows_coarse(sites, plan), pos))
    return out


def _level_parts(fn, rows, pos, dt_lo, dt_hi, cfg: StageConfig, norm):
    """[per-dt (S, ws2)] normalized contributions of one pyramid level.

    CHUNKED ONE-TAKE: the dt planes are stacked along the candidate axis
    and each site's row is gathered once per chunk instead of once per dt;
    the chunk size keeps one stacked chunk under ``_CHUNK_BYTES``.
    Per-element arithmetic is identical to the per-dt formulation."""
    ws2 = cfg.w_s * cfg.w_s
    nbytes = 2 if cfg.search_bf16 else 4
    q = max(1, min(dt_hi - dt_lo + 1,
                   _CHUNK_BYTES // max(pos * ws2 * nbytes, 1)))
    parts = []
    for c0 in range(dt_lo, dt_hi + 1, q):
        dts_c = list(range(c0, min(c0 + q, dt_hi + 1)))
        flat = jnp.concatenate([fn(dt) for dt in dts_c], axis=1)
        got = jnp.take(flat, rows, axis=0).astype(jnp.float32)
        got = got / norm
        parts.extend(got[:, i * ws2:(i + 1) * ws2]
                     for i in range(len(dts_c)))
    return parts


def _masked_planes(levels, ts, oob, t_len, dt_lo, dt_hi, cfg: StageConfig,
                   norm):
    """Per-dt (S, ws2) candidate values summed over pyramid levels, offset
    and +inf-masked (temporally invalid frames, optional ``oob``)."""
    lvl_parts = [_level_parts(fn, rows, pos, dt_lo, dt_hi, cfg, norm)
                 for fn, rows, pos in levels]
    all_vals = []
    for di, dt in enumerate(range(dt_lo, dt_hi + 1)):
        cand = lvl_parts[0][di]
        for lp in lvl_parts[1:]:
            cand = cand + lp[di]
        f = ts + dt
        valid = (f >= 0) & (f <= t_len - cfg.pt)
        cand = (cand - cfg.offset
                + jnp.where(valid, 0.0, jnp.inf)[:, None])
        if oob is not None:
            cand = cand + oob
        all_vals.append(cand)
    return all_vals


def _decode(vals, sel, ts, ys, xs, dt_lo, t_len, chw, w, cfg: StageConfig):
    """Top-K positions -> flat candidate indices (-1 where masked)."""
    ws2 = cfg.w_s * cfg.w_s
    half = (cfg.w_s - 1) // 2
    dt_i = sel // ws2 + dt_lo                               # (S, K)
    rem = sel % ws2
    fcl = jnp.clip(ts[:, None] + dt_i, 0, t_len - cfg.pt)
    y = ys[:, None] - half + rem // cfg.w_s
    x = xs[:, None] - half + rem % cfg.w_s
    inds = fcl * chw + y * w + x
    inds = jnp.where(jnp.isinf(vals), -1, inds.astype(jnp.int32))
    return vals, _apply_tau(vals, inds, cfg)


def topk_planes(all_vals, k: int):
    """Exact top-K over the concatenation of per-dt candidate planes via a
    TWO-STAGE select: per-plane ``top_k`` of the (S, ws2) planes, then one
    narrow ``top_k`` over the (S, n_dt*k) survivors, with indices mapped
    back through the plane offsets.

    Exact because the global top-K is contained in the union of per-plane
    top-Ks; BIT-EQUAL to ``lax.top_k(-concat(all_vals), k)`` including tie
    order: ``lax.top_k`` lists equal values earliest-position-first, stage
    1 therefore emits each plane's ties in position order, and stage 2's
    plane-major input preserves (plane, position) = flat-position order —
    exactly the one-shot enumeration.  Narrowing the final sort from
    n_dt*ws2 to n_dt*k candidates is what makes it cheaper than the
    one-shot sort (its GPU time is not measured yet)."""
    n_p = len(all_vals)
    s_cnt, ws2 = all_vals[0].shape
    mv = jnp.concatenate(all_vals, axis=1)
    if n_p == 1 or ws2 < k:
        neg, sel = lax.top_k(-mv, k)
        return -neg, sel
    # The planes enter through the SAME concatenate the one-shot used (the
    # two-stage view is a reshape of it) so XLA fuses the plane arithmetic
    # identically and the values stay bit-equal to the topk='stream' path
    # (pinned by tests/test_search_dense.py::test_stream_topk_bit_equal —
    # a jnp.stack variant here measurably perturbed the fused plane values
    # by 1 ulp on CPU).
    xp = mv.reshape(s_cnt, n_p, ws2)
    neg1, sel1 = lax.top_k(-xp, k)                      # (S, n_p, k)
    base = (jnp.arange(n_p, dtype=jnp.int32) * ws2)[None, :, None]
    gidx = (sel1 + base).reshape(s_cnt, n_p * k)
    neg2, sel2 = lax.top_k(neg1.reshape(s_cnt, n_p * k), k)
    sel = jnp.take_along_axis(gidx, sel2, axis=1)
    return -neg2, sel


def exec_search_dense_tile(tile, sites_local, gy, cfg: StageConfig, qrow0,
                           base_row, hp_g: int,
                           coarse_videos=()) -> Tuple[jnp.ndarray,
                                                      jnp.ndarray]:
    """Zero-flow top-K search on a halo'd strip tile — the strided-query
    search + chunked one-take, running inside ``shard_map`` (the sharded
    spatial path rides the same search the single-device pipeline does).

    tile:        (T, C, Hs + 2*halo, W) local video tile (YUV).
    sites_local: (S, 3) lattice sites in TILE coordinates.
    gy:          (S,) global rows of the sites (phase / border class).
    qrow0:       static per-frame GLOBAL lattice phases (as in proc_nl).
    base_row:    traced scalar — global row of tile row 0
                 (= strip_index*strip_h - halo; negative on strip 0).
    hp_g:        static global H - ps + 1 (of the padded global frame).
    coarse_videos: all_gather'ed FULL-frame needle pyramid levels; coarse
      distances use the GLOBAL coarse_plan layout (global coordinates
      apply — coarse frames are not sharded).

    Level-0 distances are kept only at lattice slots selected by a
    DEVICE-BUILT index (ops/lattice_layout.tile_sel_indices): the tile's
    lattice rows depend on the traced per-device ``base_row``, so the
    selection and the site->slot mapping are data while every layout shape
    stays static and device-uniform.  Candidates outside the GLOBAL frame
    are masked +inf (the halo path's border_mode='mask' semantics).
    Returns (vals, inds) with inds in TILE flat coordinates
    (t*(C*Ht*W) + y_tile*W + x).
    """
    t_len, c_full, h_t, w = tile.shape
    ps, w_s, step = cfg.ps, cfg.w_s, cfg.step_s
    half = (w_s - 1) // 2
    s_cnt = sites_local.shape[0]
    norm = float(cfg.pt * cfg.dist_chnls * cfg.ps * cfg.ps) * 255.0 ** 2
    hp_t, wp = h_t - ps + 1, w - ps + 1
    ts = sites_local[:, 0]
    ys = sites_local[:, 1]
    xs = sites_local[:, 2]
    dt_lo, dt_hi = eff_dt_range(cfg, t_len)
    pdty = jnp.bfloat16 if cfg.search_bf16 else jnp.float32

    # ---- level 0: tile lattice (traced selection) ----
    sel0 = tile_sel_indices(qrow0, base_row, hp_t, hp_g, wp, step)
    fn0, pos0 = _level(tile, cfg, pdty, sel0)
    rows0 = site_rows_smat_tile(sites_local, gy, qrow0, step, hp_t, hp_g, wp)
    levels = [(fn0, rows0, pos0)]

    # ---- coarse needle levels: GLOBAL frames, global plan (the pooled
    # pyramid is replicated, not sharded) ----
    sites_g = jnp.stack([ts, gy, xs], axis=1)
    levels += _coarse_levels(coarse_videos, cfg, qrow0, sites_g, hp_g, wp,
                             pdty)

    # ---- OOB mask: GLOBAL frame bounds in tile coordinates (traced) ----
    dgrid = jnp.arange(w_s, dtype=jnp.int32)
    cy_g = ys[:, None, None] - half + dgrid[None, :, None] + base_row
    cx = xs[:, None, None] - half + dgrid[None, None, :]
    bad = ((cy_g < 0) | (cy_g > hp_g - 1) | (cx < 0) | (cx > wp - 1))
    oob = jnp.where(bad, jnp.inf, 0.0).reshape(s_cnt, w_s * w_s)

    all_vals = _masked_planes(levels, ts, oob, t_len, dt_lo, dt_hi, cfg,
                              norm)
    vals, sel_k = topk_planes(all_vals, cfg.npatches)
    return _decode(vals, sel_k, ts, ys, xs, dt_lo, t_len, c_full * h_t * w,
                   w, cfg)


@functools.partial(jax.jit, static_argnames=("cfg", "qrow0"))
def exec_search_dense(video: jnp.ndarray, sites: jnp.ndarray,
                      cfg: StageConfig, qrow0=None
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Zero-flow top-K search over INTERIOR sites (ops/mask.interior_split).

    Args/returns match ops/search.exec_search (flows implicitly zero).

    ``qrow0``: optional static tuple of per-frame lattice phase rows
    (length t-pt+1).  When given, EVERY site must lie on the coverage
    lattice (phase rows plus the always-on border rows) and the candidate
    distances of every level are kept only at lattice positions (~step_s^2
    fewer stored values than the all-pixels planes, bit-equal values).
    ``None`` (arbitrary sites, e.g. compat mode / tests) keeps the
    all-pixels path.
    """
    t_len, c_full, h, w = video.shape
    k = cfg.npatches
    ps, w_s = cfg.ps, cfg.w_s
    half = (w_s - 1) // 2
    s_cnt = sites.shape[0]
    norm = float(cfg.pt * cfg.dist_chnls * cfg.ps * cfg.ps) * 255.0 ** 2
    if cfg.dense_rows == "full":
        qrow0 = None
    pdty = jnp.bfloat16 if cfg.search_bf16 else jnp.float32

    # pyramid levels (needle) — interior_split guarantees validity per level
    videos = [video]
    if cfg.stype == "needle":
        r = w_s + ps - 1
        for _ in range(1, cfg.needle_scales):
            lh, lw = videos[-1].shape[2] // 2, videos[-1].shape[3] // 2
            if lh < r or lw < r:
                break
            videos.append(_avg_pool2(videos[-1]))

    levels = []             # [(per_dt -> (pos, ws2), site rows, pos)]
    if qrow0 is not None:
        # strided-query layouts: level 0 and every coarse level (the
        # per-phase coarse_plan needs no stride divisibility)
        hp0, wp0 = h - ps + 1, w - ps + 1
        sel0 = smat_sel_indices(qrow0, hp0, wp0, cfg.step_s)
        fn0, pos0 = _level(video, cfg, pdty, jnp.asarray(sel0))
        levels.append((fn0, site_rows_smat(sites, qrow0, cfg.step_s, hp0,
                                           wp0), pos0))
        levels += _coarse_levels(videos[1:], cfg, qrow0, sites, hp0, wp0,
                                 pdty)
    else:
        for lvl, v in enumerate(videos):
            lh, lw = v.shape[2], v.shape[3]
            fn, pos = _level(v, cfg, pdty)
            levels.append((fn, _site_rows(sites, 1 << lvl, lh - ps + 1,
                                          lw - ps + 1, lh, lw, ps, half),
                           pos))

    ts = sites[:, 0]
    ys = sites[:, 1]
    xs = sites[:, 2]
    dt_lo, dt_hi = eff_dt_range(cfg, t_len)

    # border_mode == "mask": sites may sit near the frame border; their
    # out-of-bounds candidates read zero-padded garbage from the dense
    # buffers and are masked +inf here (the top-K then selects from the
    # fewer in-bounds candidates — a documented delta vs the C++ sliding
    # window, which keeps w_s^2 candidates by shifting the window inward).
    # Masking is ADDITIVE (+inf) rather than a per-plane select: x + inf ==
    # inf and x + 0.0 == x exactly, so the additive form is bitwise
    # identical on the finite candidates and lowers to one fused add.
    oob = None
    if cfg.border_mode == "mask":
        dgrid = jnp.arange(w_s, dtype=jnp.int32)
        cy_all = ys[:, None, None] - half + dgrid[None, :, None]
        cx_all = xs[:, None, None] - half + dgrid[None, None, :]
        bad = ((cy_all < 0) | (cy_all > h - ps)
               | (cx_all < 0) | (cx_all > w - ps))
        oob = jnp.where(bad, jnp.inf, 0.0).reshape(s_cnt, w_s * w_s)

    ws2 = w_s * w_s
    if cfg.topk == "stream" and ws2 >= k:
        # STREAMING per-dt merge: a running (S, K) top-K merges with each
        # dt plane, so the peak candidate buffer is O(S*(K+ws2)) instead of
        # O(S*n_dt*ws2) (~14x smaller at the iphone preset).  Bit-equal to
        # the one-shot top_k: for equal values top_k keeps the earliest
        # position, and running entries (earlier dt, by induction) precede
        # the new plane's enumeration-ordered candidates — exactly the
        # one-shot tie order (pinned by tests/test_search_dense.py).  It
        # runs n_dt dependent top_k calls instead of one wide one, so it
        # is the LOW-MEMORY mode for long/large clips, not the default.
        def plane(dt):
            cand = jnp.zeros((s_cnt, ws2), jnp.float32)
            for fn, rows, _ in levels:
                got = jnp.take(fn(dt), rows, axis=0).astype(jnp.float32)
                cand = cand + got / norm
            f = ts + dt
            valid = (f >= 0) & (f <= t_len - cfg.pt)
            cand = cand - cfg.offset + jnp.where(valid, 0.0,
                                                 jnp.inf)[:, None]
            return cand if oob is None else cand + oob

        run_v = run_s = None
        for di, dt in enumerate(range(dt_lo, dt_hi + 1)):
            cand = plane(dt)
            code = di * ws2 + jnp.arange(ws2, dtype=jnp.int32)
            if run_v is None:
                neg, sel_p = lax.top_k(-cand, k)
                run_v, run_s = -neg, jnp.take(code, sel_p)
            else:
                mv = jnp.concatenate([run_v, cand], axis=1)
                mc = jnp.concatenate(
                    [run_s, jnp.broadcast_to(code, cand.shape)], axis=1)
                neg, sel_p = lax.top_k(-mv, k)
                run_v = -neg
                run_s = jnp.take_along_axis(mc, sel_p, axis=1)
        vals, sel = run_v, run_s
    else:
        all_vals = _masked_planes(levels, ts, oob, t_len, dt_lo, dt_hi, cfg,
                                  norm)
        # one-shot top-K over the full candidate axis (enumeration dt, dy,
        # dx — identical to the gather path, so ties break identically).
        # Candidate flat indices are DECODED from the selected positions
        # instead of materializing an (S, n_dt*ws2) int32 array.
        if cfg.topk == "approx":
            # lax.approx_max_k: where the backend has no approximate
            # kernel XLA computes it exactly; otherwise slight recall loss
            # swaps the rare boundary candidate for a near-equal one
            mv = jnp.concatenate(all_vals, axis=1)          # (S, n_dt*ws2)
            neg, sel = lax.approx_max_k(-mv, k, recall_target=0.98)
            vals = -neg
        else:
            vals, sel = topk_planes(all_vals, k)

    return _decode(vals, sel, ts, ys, xs, dt_lo, t_len, c_full * h * w, w,
                   cfg)
