"""One denoising pass (``proc_nl``), fully jitted.

Reference: lib/vnlb/proc_nl.py:38-141 — a Python batch loop with host syncs,
random site draws, and a CPU aggregation detour.  Redesign (SURVEY.md §7):
the entire pass is ONE jitted function; the batch loop is a ``lax.scan``
over fixed-size site batches enumerated from the coverage lattice; search,
gather, Bayes filtering and scatter-add aggregation all stay on device with
static shapes.  Sites and their order are fixed; on the GPU the f32
scatter-add combines duplicate rows with atomics in no fixed order, so two
runs differ in the last bits (ROADMAP B2); on the CPU they are bitwise
identical.

``accumulate`` is the shared core (scan over site batches -> accumulators);
the single-device ``proc_nl`` and the multi-chip ``parallel.tiled`` paths both
build on it.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import StageConfig
from .ops import agg, bayes, color, flat, gather, search
from .ops.mask import batched_sites


def precompute_inds(srch_yuv, fflow, bflow, site_batches, cfg: StageConfig,
                    shape, n_dense_batches: int = 0, dense_search_fn=None,
                    y_bounds=None, search_ctx=None,
                    coarse_global: bool = False, qrow0=None):
    """Phase 1: the search for every site batch -> inds (NB, B, K).

    The first ``n_dense_batches`` batches hold interior sites and are
    searched with the dense zero-flow path (ops/search_dense) in ONE call —
    candidate distances are shared across the whole frame.  Remaining
    (border / flow-driven) batches use the per-site gather path under a
    scan.  ``dense_search_fn(srch, sites) -> (vals, inds)`` overrides the
    dense search (the halo-sharded path injects its tile-local variant).
    """
    from .ops.search_dense import exec_search_dense

    nb, bsz, _ = site_batches.shape
    parts = []
    vparts = []
    if n_dense_batches:
        dense_sites = site_batches[:n_dense_batches].reshape(-1, 3)
        if dense_search_fn is None:
            vals_d, inds_d = exec_search_dense(srch_yuv, dense_sites, cfg,
                                               qrow0=qrow0)
        else:
            vals_d, inds_d = dense_search_fn(srch_yuv, dense_sites)
        parts.append(inds_d.reshape(n_dense_batches, bsz, -1))
        vparts.append(vals_d.reshape(n_dense_batches, bsz, -1))
    if n_dense_batches < nb:
        ctx = search_ctx or search.build_search_ctx(srch_yuv, cfg)

        def body(_, sites):
            return None, search.exec_search(srch_yuv, sites, fflow, bflow,
                                            cfg, ctx=ctx, y_bounds=y_bounds,
                                            coarse_global=coarse_global)

        _, (vals_g, inds_g) = jax.lax.scan(body, None,
                                           site_batches[n_dense_batches:])
        parts.append(inds_g)
        vparts.append(vals_g)
    if len(parts) == 1:
        return vparts[0], parts[0]
    return jnp.concatenate(vparts, axis=0), jnp.concatenate(parts, axis=0)


def accumulate(noisy_yuv, basic_yuv, srch_yuv, fflow, bflow, site_batches,
               valid_batches, cfg: StageConfig, shape, axis_name=None,
               n_dense_batches: int = 0, dense_search_fn=None,
               y_bounds=None, search_ctx=None, coarse_global: bool = False,
               qrow0=None, prof_upto: str = ""):
    """Scan all site batches; returns image-space (deno (T,C,H,W),
    weights (T,H,W)) accumulators (un-normalized).

    Data layout: the videos are unfolded once into patch columns
    (ops/gather.im2col), so every patch-group gather is a contiguous row
    gather and aggregation is a row scatter into column space, folded
    densely back to image space once at the end (ops/agg.fold).  The search
    runs as a separate phase (``precompute_inds``) so the dense zero-flow
    path can share candidate work across the whole frame.

    ``axis_name`` marks the accumulators as device-varying when running
    inside ``shard_map`` (scan carry typing).

    ``prof_upto`` (PROFILING ONLY): truncate
    the pass after the named phase and return a forcing scalar instead of
    the accumulators, so jitted-prefix differences measure true in-context
    marginal phase costs on the production graph.  Must be threaded as a
    static jit argument (not read from the environment) so each prefix
    compiles its own executable.
    """
    t_len, c, h, w = shape
    hp, wp = h - cfg.ps + 1, w - cfg.ps + 1
    d = c * cfg.ps * cfg.ps

    vals_batches, inds_batches = precompute_inds(
        srch_yuv, fflow, bflow, site_batches, cfg, shape, n_dense_batches,
        dense_search_fn, y_bounds, search_ctx, coarse_global, qrow0)
    if prof_upto == "search":
        return jnp.sum(vals_batches) + jnp.sum(inds_batches)

    cdty = jnp.bfloat16 if cfg.cols_bf16 else jnp.float32
    # pt-fused arenas: a pt-frame patch is ONE row gather instead of pt
    # (gather.cols_fuse_pt) for a pt x bigger arena; skip the fusion when
    # the arena would not comfortably fit HBM (long 1080p streaming
    # windows), where the extra rows are cheaper than the memory
    fuse_pt = (cfg.pt > 1 and t_len * hp * wp * cfg.pt * d
               * (2 if cfg.cols_bf16 else 4) <= int(3e9))

    # step 2 gathers noisy AND basic patches at the SAME rows: a lane-joined
    # arena turns the two takes into one (take cost is ~per-row); gate on
    # the joint arena fitting comfortably (long streaming windows fall back)
    join_arenas = (cfg.step == 1 and fuse_pt
                   and 2 * t_len * hp * wp * cfg.pt * d
                   * (2 if cfg.cols_bf16 else 4) <= int(5e9))

    def build_cols(img_yuv):
        if fuse_pt:
            # pt-fusion rides the one-hot conv's output channels
            # (gather.arena_conv; bitwise equal to unfold + cols_fuse_pt)
            return gather.arena_conv([img_yuv], cfg.ps, cfg.pt,
                                     bf16=cfg.cols_bf16)
        # one-hot-conv unfold (bitwise equal to gather.im2col, one conv)
        cols = gather.im2col_conv(img_yuv, cfg.ps, bf16=cfg.cols_bf16)
        return cols.reshape(t_len * hp * wp, d)

    if join_arenas:
        # ONE conv emits the joined c-major pt-fused arena — no roll/concat
        # relayout graph
        cols_join = gather.arena_conv([noisy_yuv, basic_yuv], cfg.ps, cfg.pt,
                                      bf16=cfg.cols_bf16)
        cols_noisy = cols_basic = None
    else:
        cols_join = None
        cols_noisy = build_cols(noisy_yuv)
        cols_basic = build_cols(basic_yuv) if cfg.step == 1 else None
    if prof_upto == "arena":
        arena = cols_join if join_arenas else cols_noisy
        forced = jnp.sum(arena.astype(jnp.float32)[::1009])
        if cols_basic is not None and not join_arenas:
            forced = forced + jnp.sum(cols_basic.astype(jnp.float32)[::1009])
        return forced + jnp.sum(vals_batches)

    # pt*D patch lanes + 1 fused weight-count lane (see agg.agg_rows)
    def make_acc0():
        acc0 = jnp.zeros((t_len * hp * wp, cfg.pt * d + 1), jnp.float32)
        if axis_name is not None:
            acc0 = jax.lax.pcast(acc0, axis_name, to="varying")
        return acc0

    # ONE deferred scatter instead of per-batch scatters in the scan: the
    # scan stacks (rows, updates) — contiguous writes — and the scatter
    # runs once at the end (one large op amortizes per-row read-modify-
    # writes; GPU cost not measured separately).  Falls back to in-scan
    # scatters when the stacked update buffer would be too large (long
    # windows, e.g. 1080p streaming chunks) — a fixed gate sized for the
    # small device memory of the accelerator this pipeline was first
    # written for; it picks a slower path with equal results and is safe
    # on an 80 GB card.  ROADMAP A7 derives it from memory_stats().
    nb = site_batches.shape[0]
    ka = (cfg.agg_k if cfg.agg_k and cfg.agg_k < cfg.npatches
          else cfg.npatches)
    upd_bytes = (nb * cfg.bsize * ka * (cfg.pt * d + 1)
                 * (2 if cfg.agg_bf16 else 4))
    global_scatter = upd_bytes <= int(3e9)

    def body(acc, xs):
        valid, inds, vals = xs
        rows = gather.inds_to_rows(inds, shape, cfg.ps, cfg.pt)

        if join_arenas:
            pnoisy, pbasic = gather.fill_patches_cols_joint(
                cols_join, rows[:, :, 0], cfg.pt, cfg.ps, c)
        elif fuse_pt:
            pnoisy = gather.fill_patches_cols_fused(
                cols_noisy, rows[:, :, 0], cfg.pt, cfg.ps, c)
            pbasic = (gather.fill_patches_cols_fused(
                cols_basic, rows[:, :, 0], cfg.pt, cfg.ps, c)
                if cfg.step == 1 else None)
        else:
            pnoisy = gather.fill_patches_cols(cols_noisy, rows,
                                              cfg.pt, cfg.ps, c)
            pbasic = (gather.fill_patches_cols(cols_basic, rows,
                                               cfg.pt, cfg.ps, c)
                      if cfg.step == 1 else None)

        if prof_upto == "gather":
            forced = jnp.sum(pnoisy.astype(jnp.float32))
            if pbasic is not None:
                forced = forced + jnp.sum(pbasic.astype(jnp.float32))
            return acc, forced

        if cfg.deno == "bayes":
            flat_flags = (flat.flat_areas(pnoisy, cfg.gamma, cfg.sigma2)
                          if (cfg.step == 1 and cfg.flat_areas)
                          else jnp.zeros((valid.shape[0],), bool))
            if cfg.step == 1:
                pfilt, _ = bayes.bayes_denoise(pnoisy, pbasic, flat_flags, cfg)
            else:
                pfilt, _ = bayes.bayes_denoise(pnoisy, None, None, cfg)
        elif cfg.deno == "ave":
            pfilt = bayes.ave_denoise(pnoisy)
            if pfilt.ndim == 4:
                # c-major rows -> public (B, K, pt, c, ps, ps) layout so the
                # scatter-update lanes match the accumulator's (pt, c, ps2)
                # order (identity when pt == 1)
                b4, k4 = pfilt.shape[:2]
                pfilt = jnp.transpose(
                    pfilt.reshape(b4, k4, c, cfg.pt, cfg.ps * cfg.ps),
                    (0, 1, 3, 2, 4)).reshape(b4, k4, cfg.pt, c,
                                             cfg.ps, cfg.ps)
        else:
            raise ValueError(f"unknown deno mode [{cfg.deno}]")

        if prof_upto == "bayes":
            return acc, jnp.sum(pfilt)

        valid_k = valid[:, None] & (inds >= 0)
        if cfg.only_frame >= 0:
            # aggregate only patches whose corner frame matches (reference
            # comp_agg.py:234 semantics)
            f_dec = jnp.clip(jnp.maximum(inds, 0) // (c * h * w),
                             0, t_len - cfg.pt)
            valid_k = valid_k & (f_dec == cfg.only_frame)
        if cfg.agg_k and cfg.agg_k < cfg.npatches:
            # thin the scatter to the best agg_k candidates (vals ascend, so
            # the leading K' rows are the closest patches); the Bayes prior
            # above still used all K
            ka = cfg.agg_k
            pfilt, valid_k = pfilt[:, :ka], valid_k[:, :ka]
            rows, vals = rows[:, :ka], vals[:, :ka]
        if cfg.agg_weight == "exp":
            # NLM-style distance weighting: closer candidates contribute
            # more to the average; vals are per-pixel squared distances on
            # the [0,1] scale minus offset -> scale by agg_h * sigma^2
            wk = jnp.exp(-jnp.maximum(vals, 0.0) * (255.0 ** 2)
                         / (cfg.agg_h * cfg.sigma2))
            wts_k = valid_k.astype(jnp.float32) * wk
        else:
            wts_k = valid_k.astype(jnp.float32)
        if not global_scatter:
            acc = agg.agg_rows(acc, pfilt, rows[:, :, 0], wts_k)
            return acc, None
        b_, k_ = wts_k.shape
        vm = wts_k[:, :, None].astype(pfilt.dtype)
        upd = jnp.concatenate(
            [pfilt.reshape(b_, k_, cfg.pt * d) * vm, vm], axis=-1)
        if cfg.agg_bf16:
            # bf16 STACK (not accumulator): the one-shot scatter upcasts to
            # the f32 accumulator, so only the per-patch update values round
            # (uniform 0/1 weight-lane entries are exact in bf16)
            upd = upd.astype(jnp.bfloat16)
        # stack FLATTENED, folded to (8, flat/8), so every per-step
        # dynamic-update-slice writes whole contiguous rows; the final
        # (-1, ptd+1) reshape stays a free bitcast.
        updf = upd.reshape(-1)
        if updf.shape[0] % 8 == 0:
            updf = updf.reshape(8, -1)
        return acc, (rows[:, :, 0].reshape(-1), updf)

    xs_all = (valid_batches, inds_batches, vals_batches)
    if prof_upto in ("gather", "bayes"):
        _, ys = jax.lax.scan(lambda _, xs: body(None, xs), None, xs_all)
        return jnp.sum(ys)
    if global_scatter:
        # the accumulator is UNTOUCHED inside this scan — create it after,
        # so the scan does not carry (and copy) the multi-GB buffer
        _, ys = jax.lax.scan(lambda _, xs: body(None, xs), None, xs_all)
        rows_all, upd_all = ys
        if prof_upto == "stack":
            return (jnp.sum(rows_all)
                    + jnp.sum(upd_all.reshape(-1, cfg.pt * d + 1)[:, -1]))
        # same global row order as the sequential in-scan scatters; XLA:CPU
        # combines duplicate rows in index order (bitwise equal to the
        # scan-scatter path there), XLA:GPU with atomics in no fixed order
        acc = make_acc0().at[rows_all.reshape(-1)].add(
            upd_all.reshape(-1, cfg.pt * d + 1).astype(jnp.float32),
            mode="drop")
    else:
        acc, _ = jax.lax.scan(body, make_acc0(), xs_all)
    if prof_upto == "scatter":
        return jnp.sum(acc[::997])
    return agg.fold(acc, cfg.pt, cfg.ps, shape)


def select_search_image(noisy_yuv, basic_yuv, clean_yuv, cfg: StageConfig):
    return {"noisy": noisy_yuv, "basic": basic_yuv,
            "clean": clean_yuv}[cfg.srch_img]


@functools.partial(jax.jit,
                   static_argnames=("cfg", "shape", "n_dense_batches",
                                    "qrow0", "prof_upto"))
def _proc_nl_jit(noisy, basic, clean, fflow, bflow, site_batches,
                 valid_batches, cfg: StageConfig, shape,
                 n_dense_batches: int = 0, qrow0=None,
                 prof_upto: str = ""):
    noisy_yuv = color.rgb2yuv(noisy)
    basic_yuv = color.rgb2yuv(basic)
    clean_yuv = color.rgb2yuv(clean)
    srch = select_search_image(noisy_yuv, basic_yuv, clean_yuv, cfg)

    out = accumulate(noisy_yuv, basic_yuv, srch, fflow, bflow,
                     site_batches, valid_batches, cfg, shape,
                     n_dense_batches=n_dense_batches,
                     qrow0=qrow0, prof_upto=prof_upto)
    if prof_upto and prof_upto != "full":
        return out
    deno_img, wts_img = out

    fallback = basic_yuv if cfg.step == 1 else noisy_yuv
    deno_yuv = agg.finalize_img(deno_img, wts_img, fallback)
    return color.yuv2rgb(deno_yuv)


def _pad_batch(sites, bsize):
    s = sites.shape[0]
    nb = -(-s // bsize) if s else 0
    pad = nb * bsize - s
    valid = np.ones((s,), dtype=bool)
    if pad:
        filler = sites[:1] if s else np.zeros((1, 3), np.int32)
        sites = np.concatenate([sites, np.tile(filler, (pad, 1))], axis=0)
        valid = np.concatenate([valid, np.zeros((pad,), bool)])
    return sites.reshape(nb, bsize, 3), valid.reshape(nb, bsize)


def plan_sites(shape, cfg: StageConfig, zero_flow: bool, t_origin: int = 0):
    """Host-side site planning (static per shape/config).

    With zero flow, interior sites go first (searched densely in one call),
    border sites after (gather path); otherwise one raster-order batching.
    Returns (site_batches, valid_batches, n_dense_batches).  ``t_origin``
    anchors the lattice phases to global frame indices (streaming chunks).
    """
    if not zero_flow:
        sb, vb = batched_sites(shape, cfg, t_origin=t_origin)
        return sb, vb, 0
    from .ops.mask import interior_split, lattice_sites

    sites = lattice_sites(shape, cfg, t_origin)
    if cfg.border_mode == "mask":
        # every site rides the dense path; OOB candidates are masked +inf
        # inside exec_search_dense
        interior, border = sites, sites[:0]
    else:
        interior, border = interior_split(sites, shape, cfg)
    sbi, vbi = _pad_batch(interior, cfg.bsize)
    sbb, vbb = _pad_batch(border, cfg.bsize)
    if sbi.shape[0] == 0:
        return sbb, vbb, 0
    if sbb.shape[0] == 0:
        return sbi, vbi, sbi.shape[0]
    return (np.concatenate([sbi, sbb]), np.concatenate([vbi, vbb]),
            sbi.shape[0])


def proc_nl(noisy, basic: Optional[jnp.ndarray], clean: Optional[jnp.ndarray],
            fflow, bflow, cfg: StageConfig,
            zero_flow: Optional[bool] = None, t_origin: int = 0,
            prof_upto: str = "") -> jnp.ndarray:
    """Run one VNLB pass; RGB (T,C,H,W) in, RGB denoised out.

    ``zero_flow`` selects the dense shared-candidate search (exact for the
    default zero-flow configuration); auto-detected from the flow values
    when not given.  ``t_origin`` = global index of frame 0 (streaming
    chunks; aligns the coverage-lattice phases with the monolithic run).
    """
    from .utils.index import check_codec_range

    noisy = jnp.asarray(noisy, jnp.float32)
    shape = tuple(int(s) for s in noisy.shape)
    check_codec_range(shape)
    r = cfg.w_s + cfg.ps - 1
    if shape[2] < r or shape[3] < r:
        raise ValueError(
            f"frame {shape[2]}x{shape[3]} smaller than search region "
            f"{r}x{r}; reduce w_s or pad the video")
    basic = noisy if basic is None else jnp.asarray(basic, jnp.float32)
    clean = noisy if clean is None else jnp.asarray(clean, jnp.float32)
    if zero_flow is None:
        zero_flow = (not np.any(np.asarray(fflow))
                     and not np.any(np.asarray(bflow)))
    fflow = jnp.asarray(fflow, jnp.float32)
    bflow = jnp.asarray(bflow, jnp.float32)

    sb, vb, n_dense = plan_sites(shape, cfg, zero_flow, t_origin)
    # coverage-lattice phase rows (static): lets the dense search compute
    # level-0 distances only at query rows (ops/search_dense strided path)
    qrow0 = None
    if zero_flow and n_dense:
        end_t = shape[0] - cfg.pt + 1
        qrow0 = tuple(
            ((f + t_origin) % cfg.step_s) if f < end_t - 1 else 0
            for f in range(end_t))
    return _proc_nl_jit(noisy, basic, clean, fflow, bflow,
                        jnp.asarray(sb), jnp.asarray(vb), cfg, shape,
                        n_dense_batches=n_dense, qrow0=qrow0,
                        prof_upto=prof_upto)
