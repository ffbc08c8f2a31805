"""Space-time top-K similar-patch search (pure-JAX/XLA implementation).

Replaces the reference's external numba-CUDA kernel
``vpss.exec_sim_search_burst`` (called at lib/vnlb/search/search.py:88-89;
contract reconstructed in SURVEY.md §2.2 N1): for every query site
``(t, h, w)`` scan a ``w_s × w_s`` spatial window over frames
``t-nwt_b .. t+nwt_f``, with per-frame window centers tracked along the
optical-flow trajectory, and return the K smallest patch distances plus the
flat indices (codec ``t*(c*h*w) + y*w + x``) of the matching patch corners.

Design decisions
----------------
* Static shapes everywhere: every site always evaluates exactly
  ``n_dt * w_s**2`` candidates.  Near spatial borders the window *slides* to
  stay inside the valid patch area (the C++ oracle implements the identical
  sliding rule), keeping the candidate count constant and duplicate-free.
  Temporally-invalid frames are masked with +inf distances; since
  ``w_s**2 >= K`` for every preset, at least K valid candidates always exist.
* Distances are computed with matrix units via the decomposition
  ``||q - c||^2 = ||q||^2 + ||c||^2 - 2 q.c``: for each (site, frame) the
  halo'd search region is gathered once and a single grouped convolution
  produces both the cross-correlation ``q.c`` and the box-sum ``||c||^2``.
* Distances are L2 on the first ``dist_chnls`` channels (the C++ algorithm
  uses Y only in step 0 and all channels of the basic estimate in step 1),
  normalized to the [0,1] pixel scale and offset-subtracted:
  ``d = sum((a-b)^2) / (pt*c_d*ps^2 * 255^2) - offset``.  The normalization is
  monotone, so the selected top-K set matches the un-normalized ranking.
* Ties break toward the smallest candidate enumeration index — candidates are
  enumerated (frame ascending, then y, then x), so the earliest raster
  position wins, and the query patch itself (distance ``-offset``) is always
  selected first among zero-distance ties.
* ``stype == "needle"`` augments the distance with coarse-scale terms from an
  average-pooled pyramid (a static-shape stand-in for the reference's
  needle-match mode, params.py:88).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import StageConfig


def _round_half_up(x):
    return jnp.floor(x + 0.5)


def eff_dt_range(cfg, t_len: int):
    """Static clamp of the temporal offset range: dt can only be valid when
    some site has 0 <= t+dt <= T-pt, i.e. |dt| <= T-pt.  Clips shorter than
    the temporal window then skip the all-masked offset planes entirely;
    the enumeration order of the remaining planes (dt ascending) is
    unchanged, so tie-breaks — and the returned (vals, inds) — are
    identical."""
    return (max(-cfg.nwt_b, -(t_len - cfg.pt)),
            min(cfg.nwt_f, t_len - cfg.pt))


def track_centers(sites: jnp.ndarray, fflow: jnp.ndarray, bflow: jnp.ndarray,
                  nwt_b: int, nwt_f: int, shape, y_bounds=None) -> jnp.ndarray:
    """Flow-tracked window centers.

    Returns int32 (B, n_dt, 2) = (cy, cx) for dt = -nwt_b .. +nwt_f (frame
    ascending).  Centers accumulate flow in float and are rounded at use,
    clamped to the image; with zero flows every center equals the query pixel
    (matching the default ``denoise()`` path, reference impl.py:45 allocates
    zero flows).

    ``y_bounds``: optional traced (y0, y1) — the FIRST and LAST valid image
    rows in this array's coordinates.  Used by the halo-sharded mode, where
    the array is a strip tile and the global frame bounds sit at
    tile-coordinate offsets (parallel/halo.py); defaults to (0, H-1).
    """
    t_len, _, h, w = shape
    y0, y1 = (0, h - 1) if y_bounds is None else y_bounds
    y0f = jnp.float32(y0)
    y1f = jnp.float32(y1)
    tq = sites[:, 0]
    cy0 = sites[:, 1].astype(jnp.float32)
    cx0 = sites[:, 2].astype(jnp.float32)

    def lookup(flow, f_idx, cy, cx):
        fi = jnp.clip(f_idx, 0, t_len - 1)
        # flow reads must stay inside the physical array AND the global
        # frame (the two coincide except in halo tiles)
        yi = jnp.clip(_round_half_up(cy),
                      jnp.maximum(y0, 0),
                      jnp.minimum(y1, h - 1)).astype(jnp.int32)
        xi = jnp.clip(_round_half_up(cx), 0, w - 1).astype(jnp.int32)
        u = flow[fi, 0, yi, xi]
        v = flow[fi, 1, yi, xi]
        return u, v

    fwd = [(cy0, cx0)]
    cy, cx = cy0, cx0
    for i in range(nwt_f):
        u, v = lookup(fflow, tq + i, cy, cx)
        cy = jnp.clip(cy + v, y0f, y1f)
        cx = jnp.clip(cx + u, 0.0, w - 1.0)
        fwd.append((cy, cx))

    bwd = []
    cy, cx = cy0, cx0
    for i in range(nwt_b):
        u, v = lookup(bflow, tq - i, cy, cx)
        cy = jnp.clip(cy + v, y0f, y1f)
        cx = jnp.clip(cx + u, 0.0, w - 1.0)
        bwd.append((cy, cx))
    bwd = bwd[::-1]

    chain = bwd + fwd  # frame ascending: t-nwt_b .. t+nwt_f
    cy = jnp.stack([c[0] for c in chain], axis=1)
    cx = jnp.stack([c[1] for c in chain], axis=1)
    centers = jnp.stack([cy, cx], axis=-1)
    return _round_half_up(centers).astype(jnp.int32)


def _window_starts(centers, w_s, ps, h, w, y_bounds=None):
    """Sliding-window top-left corners, keeping all w_s candidates in-bounds.

    start = clip(center - (w_s-1)//2, 0, (H-ps) - (w_s-1)); if the image is
    smaller than the window the lower clip wins (candidates then clamp
    per-coordinate, tiny-image degenerate case).  ``y_bounds`` expresses
    the GLOBAL frame rows in this array's coordinates (halo tiles).
    """
    half = (w_s - 1) // 2
    if y_bounds is None:
        ylo, yhi = 0, max(h - ps - (w_s - 1), 0)
    else:
        y0, y1 = y_bounds
        ylo = y0
        yhi = jnp.maximum(y1 + 1 - ps - (w_s - 1), y0)
    sy = jnp.clip(centers[..., 0] - half, ylo, yhi)
    sx = jnp.clip(centers[..., 1] - half, 0, max(w - ps - (w_s - 1), 0))
    return sy, sx


def x_im2col(video, r):
    """Row-segment unfolding for fast region gathers.

    (T, c_d, H, W) -> flat (T*H*W', c_d*r) with W' = W-r+1: row (t, y, x)
    holds video[t, :, y, x:x+r].  Region gathers then become contiguous
    row-segment gathers (gathers of small 2-D slices are much slower).
    """
    t, c, h, w = video.shape
    wp = w - r + 1
    seg = jnp.stack([video[:, :, :, dx:dx + wp] for dx in range(r)], axis=-1)
    seg = jnp.transpose(seg, (0, 2, 3, 1, 4))        # (T, H, W', c_d, r)
    return seg.reshape(t * h * wp, c * r)


def x_im2col_rfused(video, r):
    """r-row-fused unfolding: row (t, y, x) holds the WHOLE r x r region
    video[t, :, y:y+r, x:x+r], so a region gather is ONE row take instead
    of r — a take's cost grows with its row count (r x the arena memory; the
    build is r dense shifted copies).  Wrapped bottom rows are only ever
    addressed by clamped (invalid) regions whose values are masked."""
    t, c, h, w = video.shape
    wp = w - r + 1
    plain = x_im2col(video, r)                       # (T*H*W', c*r)
    parts = [plain]
    for i in range(1, r):
        parts.append(jnp.roll(plain, -i * wp, axis=0))
    return jnp.concatenate(parts, axis=1)            # (T*H*W', r*c*r)


def _gather_regions_cols(xcols_flat, f_idx, sy, sx, pt, c_d, r, t_len, h, w):
    """Row-segment gather: (B, n_dt) starts -> (B, n_dt, pt, c_d, r, r).

    Accepts either the plain arena (c_d*r lanes: r takes per region) or
    the r-fused one (r*c_d*r lanes: ONE take per region), detected by
    lane width."""
    wp = w - r + 1
    b, n_dt = f_idx.shape
    f = jnp.clip(f_idx, 0, t_len - pt)                       # (B, n_dt)
    dtp = jnp.arange(pt, dtype=jnp.int32)                    # frames in patch
    if xcols_flat.shape[1] == r * c_d * r:
        idx = ((f[:, :, None] + dtp[None, None, :]) * h
               + sy[:, :, None]) * wp + sx[:, :, None]       # (B, n_dt, pt)
        seg = jnp.take(xcols_flat, idx.reshape(-1), axis=0)
        seg = seg.reshape(b, n_dt, pt, r, c_d, r)
    else:
        row = jnp.arange(r, dtype=jnp.int32)                 # rows in region
        idx = ((f[:, :, None, None] + dtp[None, None, :, None]) * h
               + sy[:, :, None, None] + row[None, None, None, :]) * wp \
            + sx[:, :, None, None]                           # (B, n_dt, pt, r)
        seg = jnp.take(xcols_flat, idx.reshape(-1), axis=0)  # (., c_d*r)
        seg = seg.reshape(b, n_dt, pt, r, c_d, r)
    return jnp.transpose(seg, (0, 1, 2, 4, 3, 5))            # (B,n_dt,pt,c_d,r,r)


def _gather_query(video, sites, pt, c_d, ps):
    t_len = video.shape[0]

    def one(s):
        f = jnp.clip(s[0], 0, t_len - pt)
        return lax.dynamic_slice(video, (f, 0, s[1], s[2]), (pt, c_d, ps, ps))

    return jax.vmap(one)(sites)


def _level_distances(video, xcols_flat, sites, centers, cfg: StageConfig,
                     y_bounds=None):
    """Raw (un-normalized) squared distances for one pyramid level.

    video: (T, C, H, W); xcols_flat: x_im2col of video[:, :c_d] (or None to
    build on the fly); sites (B, 3); centers (B, n_dt, 2) int32.
    Returns d (B, n_dt, w_s, w_s) float32 and (sy, sx) window corners.
    """
    t_len, _, h, w = video.shape
    ps, pt, c_d, w_s = cfg.ps, cfg.pt, cfg.dist_chnls, cfg.w_s
    dt_lo, dt_hi = eff_dt_range(cfg, t_len)
    n_dt = dt_hi - dt_lo + 1
    r = w_s + ps - 1
    if h < r or w < r:
        raise ValueError(
            f"frame {h}x{w} smaller than search region {r}x{r}; "
            f"reduce w_s or pad the video")

    dts = jnp.arange(dt_lo, dt_hi + 1, dtype=jnp.int32)
    f_idx = sites[:, 0:1] + dts[None, :]                      # (B, n_dt)

    sy, sx = _window_starts(centers, w_s, ps, h, w, y_bounds)  # (B, n_dt)
    vdist = video[:, :c_d]
    if xcols_flat is None:
        xcols_flat = x_im2col(vdist, r)
    regions = _gather_regions_cols(xcols_flat, f_idx, sy, sx, pt, c_d, r,
                                   t_len, h, w)
    query = _gather_query(vdist, sites, pt, c_d, ps)          # (B,pt,c_d,ps,ps)

    ptc = pt * c_d
    regions = regions.reshape(-1, n_dt, ptc, r, r)
    query = query.reshape(-1, ptc, ps, ps)

    def site_dist(reg, q):
        # reg (n_dt, ptc, r, r), q (ptc, ps, ps)
        inp = jnp.concatenate([reg, reg * reg], axis=1)       # (n_dt, 2ptc, r, r)
        zeros = jnp.zeros_like(q)
        ones = jnp.ones_like(q)
        f_corr = jnp.concatenate([q, zeros], axis=0)          # (2ptc, ps, ps)
        f_box = jnp.concatenate([zeros, ones], axis=0)
        filt = jnp.stack([f_corr, f_box], axis=0)             # (2, 2ptc, ps, ps)
        out = lax.conv_general_dilated(
            inp, filt, window_strides=(1, 1), padding="VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            # full fp32: the ||a||^2+||b||^2-2ab decomposition is
            # cancellation-prone; bf16/TF32 passes reorder the top-K
            precision=lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)               # (n_dt, 2, w_s, w_s)
        qsum = jnp.sum(q * q)
        return qsum + out[:, 1] - 2.0 * out[:, 0]

    d = jax.vmap(site_dist)(regions, query)                   # (B, n_dt, w_s, w_s)
    return d, (sy, sx), f_idx


def _avg_pool2(video):
    """2x spatial average pooling of (T, C, H, W) (needle pyramid level)."""
    t, c, h, w = video.shape
    h2, w2 = h // 2, w // 2
    v = video[:, :, :h2 * 2, :w2 * 2].reshape(t, c, h2, 2, w2, 2)
    return v.mean(axis=(3, 5))


def build_search_ctx(video: jnp.ndarray, cfg: StageConfig):
    """Precompute the per-pass search context: the pyramid levels (for
    ``stype=='needle'``) and their x-im2col row-segment buffers.

    Build this ONCE per pass and hand it to ``exec_search`` — rebuilding the
    row segments per batch would dominate the search cost.
    """
    r = cfg.w_s + cfg.ps - 1

    def unfold(v):
        # r-fused arena (ONE take per region) when it fits comfortably,
        # plain otherwise — _gather_regions_cols detects by lane width
        t, _, lh, lw = v.shape
        fused_bytes = t * lh * (lw - r + 1) * cfg.dist_chnls * r * r * 4
        if fused_bytes <= int(4.5e9):
            return x_im2col_rfused(v[:, :cfg.dist_chnls], r)
        return x_im2col(v[:, :cfg.dist_chnls], r)

    n_levels = cfg.needle_scales if cfg.stype == "needle" else 1
    videos, xcols = [video], [unfold(video)]
    for _ in range(1, n_levels):
        lh, lw = videos[-1].shape[2] // 2, videos[-1].shape[3] // 2
        if lh < r or lw < r:
            break
        lvl = _avg_pool2(videos[-1])
        videos.append(lvl)
        xcols.append(unfold(lvl))
    return tuple(videos), tuple(xcols)


@functools.partial(jax.jit, static_argnames=("cfg", "coarse_global"))
def exec_search(video, sites: jnp.ndarray, fflow: jnp.ndarray,
                bflow: jnp.ndarray, cfg: StageConfig, ctx=None,
                y_bounds=None, coarse_global: bool = False
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-K similar patch search.

    Args:
      video: (T, C, H, W) float32 search image (YUV), pixel scale [0, 255].
      sites: (B, 3) int32 query sites (t, y, x), patch-corner convention;
             the full patch must fit (t <= T-pt, y <= H-ps, x <= W-ps — the
             coverage lattice guarantees this).
      fflow/bflow: (T, 2, H, W) float32 optical flows.
      cfg: stage config (static).
      ctx: optional precomputed ``build_search_ctx`` output (per-pass reuse).

    Returns:
      vals: (B, K) float32 ascending normalized distances.
      inds: (B, K) int32 flat indices (t*(C*H*W) + y*W + x).
    """
    t_len, c_full, h, w = video.shape
    k = cfg.npatches
    w_s, ps, pt = cfg.w_s, cfg.ps, cfg.pt
    if w_s * w_s < k:
        raise ValueError(f"w_s^2={w_s * w_s} < K={k}: not enough candidates")

    if ctx is None:
        ctx = build_search_ctx(video, cfg)
    videos, xcols = ctx

    centers = track_centers(sites, fflow, bflow, cfg.nwt_b, cfg.nwt_f,
                            video.shape, y_bounds)
    # keep only the statically-valid temporal offsets (see eff_dt_range)
    dt_lo, dt_hi = eff_dt_range(cfg, t_len)
    centers = centers[:, dt_lo + cfg.nwt_b:dt_hi + cfg.nwt_b + 1]

    d, (sy, sx), f_idx = _level_distances(videos[0], xcols[0], sites,
                                          centers, cfg, y_bounds)
    norm = float(cfg.pt * cfg.dist_chnls * cfg.ps * cfg.ps) * 255.0 ** 2

    if cfg.stype == "needle":
        # Coarse-to-fine pyramid terms: equal weight per level, each level
        # normalized by its own patch energy scale.
        level_sites, level_centers = sites, centers
        level_bounds = y_bounds
        if coarse_global:
            # halo-tile mode with FULL-FRAME coarse levels (the coarse
            # window spans 2^lvl x the fine halo in fine pixels, so tiles
            # cannot cover it; parallel/halo.py all_gathers the pooled
            # strips instead): shift to GLOBAL row coordinates before the
            # first halving — thereafter the full-frame static clamps apply
            assert y_bounds is not None
            shift = jnp.array([0, y_bounds[0], 0], jnp.int32)
            level_sites = level_sites - shift[None, :]
            level_centers = level_centers - jnp.array([y_bounds[0], 0],
                                                      jnp.int32)
            level_bounds = None
        nd = d / norm
        for lvl in range(1, len(videos)):
            lh, lw = videos[lvl].shape[2], videos[lvl].shape[3]
            if level_bounds is not None:
                # halo tiles pool with global-aligned parity (halo forced
                # even, see parallel/halo.py), so bounds just halve; the
                # coarse anchor/center clamps must use the GLOBAL coarse
                # frame bounds, not the tile's larger array bounds
                level_bounds = (level_bounds[0] // 2, level_bounds[1] // 2)
                y_site_hi = level_bounds[1] + 1 - ps
                y_ctr_hi = level_bounds[1]
            else:
                y_site_hi = lh - ps
                y_ctr_hi = lh - 1
            ls_y = jnp.clip(level_sites[:, 1:2] // 2, 0, y_site_hi)
            ls_x = jnp.minimum(level_sites[:, 2:3] // 2, lw - ps)
            level_sites = jnp.concatenate(
                [level_sites[:, :1], ls_y, ls_x], axis=1)
            level_centers = jnp.concatenate(
                [jnp.clip(level_centers[..., 0:1] // 2, 0, y_ctr_hi),
                 jnp.minimum(level_centers[..., 1:2] // 2, lw - 1)],
                axis=-1)
            d_lvl, _, _ = _level_distances(videos[lvl], xcols[lvl],
                                           level_sites, level_centers, cfg,
                                           level_bounds)
            nd = nd + d_lvl / norm
        d_norm = nd - cfg.offset
    else:
        d_norm = d / norm - cfg.offset

    # temporal validity mask
    valid_f = (f_idx >= 0) & (f_idx <= t_len - pt)            # (B, n_dt)
    big = jnp.float32(jnp.inf)
    d_norm = jnp.where(valid_f[:, :, None, None], d_norm, big)

    # candidate flat indices
    dy = jnp.arange(w_s, dtype=jnp.int32)
    cy = sy[:, :, None] + dy[None, None, :]                   # (B, n_dt, w_s)
    cx = sx[:, :, None] + dy[None, None, :]
    y_hi_corner = (h - ps) if y_bounds is None else (y_bounds[1] + 1 - ps)
    cy = jnp.minimum(cy, y_hi_corner)
    cx = jnp.minimum(cx, w - ps)
    fcl = jnp.clip(f_idx, 0, t_len - pt)
    chw = c_full * h * w
    cand_idx = (fcl[:, :, None, None] * chw
                + cy[:, :, :, None] * w
                + cx[:, :, None, :])                          # (B,n_dt,w_s,w_s)

    d_flat = d_norm.reshape(d_norm.shape[0], -1)
    i_flat = cand_idx.reshape(cand_idx.shape[0], -1)

    neg_vals, sel = lax.top_k(-d_flat, k)                     # ties -> lowest pos
    vals = -neg_vals
    inds = jnp.take_along_axis(i_flat, sel, axis=1)
    inds = jnp.where(jnp.isinf(vals), -1, inds)
    return vals, _apply_tau(vals, inds, cfg)


def _apply_tau(vals, inds, cfg: StageConfig):
    """C++-VNLB similarity threshold: when ``cfg.tau`` > 0, candidates whose
    mean per-pixel squared distance exceeds tau are invalidated (ind = -1 —
    excluded from aggregation, like the reference's -1 convention).  ``vals``
    are normalized to the [0,1] pixel scale and offset-subtracted, so the
    threshold on that scale is tau/255^2 - offset.  For ``stype='needle'``
    the pyramid-sum distance is compared as-is (the coarse terms only add)."""
    if cfg.tau <= 0:
        return inds
    tau_n = cfg.tau / (255.0 ** 2) - cfg.offset
    return jnp.where(vals > tau_n, -1, inds)
