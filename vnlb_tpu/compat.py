"""Reference-order processing compat mode (parity experiments).

The production pipeline (vnlb_tpu/pipeline.py) processes the whole coverage
lattice deterministically in one jitted scan — a static-shape redesign of the
reference's host-driven loop.  This module reproduces the REFERENCE's
processing order for PSNR-parity experiments (SURVEY.md §7.1's "optional
masked mode"):

* random site draws from a live work mask
  (reference lib/vnlb/search_mask/mask.py:16-28 ``mask2inds``),
* the **paste trick**: after each batch, the query site, all K matched
  patch corners, and (with ``cfg.aggre_boost``) their {self, +-1 h, +-1 w}
  dilations are removed from the mask (mask.py:37-86 ``update_mask_inds`` +
  mask.py:104-187 ``agg_boost``) — matched sites are covered by the group
  that matched them, so they never spawn their own group,
* the batch budget is fixed up front (reference utils/batching.py:10-16 +
  proc_nl.py:64,110): ceil(initial_sites / bsize) batches, early exit when
  the mask empties.

Host round-trips per batch make this mode ~an order of magnitude slower
than ``proc_nl`` — it exists to quantify the PSNR effect of the
reference's adaptive work-skipping against the deterministic lattice, not
for production use.  ``nkeep`` (reference mask.py:49-50): only the first
``nkeep`` matches dilate the mask when >= 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp

from .config import StageConfig, VnlbConfig, default_config
from .ops import agg, bayes, color, flat, gather, search
from .ops.mask import lattice_mask


def _update_mask(mask: np.ndarray, inds: np.ndarray, valid: np.ndarray,
                 shape, boost: bool, nkeep: int) -> None:
    """Clear processed sites + their matches (+ paste-trick dilation)."""
    t_len, c, h, w = shape
    chw, hw = c * h * w, h * w
    groups = inds[valid & (inds >= 0).all(axis=1)]
    if nkeep >= 0:
        groups = groups[:, :nkeep]
    if groups.size == 0:
        return
    flat_inds = groups.reshape(-1)
    f = flat_inds // chw
    y = (flat_inds % hw) // w
    x = flat_inds % w
    if boost:
        dy = np.array([0, 0, 0, 1, -1])
        dx = np.array([0, -1, 1, 0, 0])
        f = np.repeat(f, 5)
        y = (y[:, None] + dy[None, :]).reshape(-1)
        x = (x[:, None] + dx[None, :]).reshape(-1)
        ok = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        f, y, x = f[ok], y[ok], x[ok]
    mask[f, y, x] = False


def proc_nl_compat(noisy, basic, clean, fflow, bflow, cfg: StageConfig,
                   seed: int = 0, rand: bool = True) -> jnp.ndarray:
    """One denoising pass in the reference's random-masked order."""
    noisy = jnp.asarray(noisy, jnp.float32)
    shape = tuple(int(s) for s in noisy.shape)
    t_len, c, h, w = shape
    basic = noisy if basic is None else jnp.asarray(basic, jnp.float32)
    clean = noisy if clean is None else jnp.asarray(clean, jnp.float32)
    fflow = jnp.asarray(fflow, jnp.float32)
    bflow = jnp.asarray(bflow, jnp.float32)

    noisy_yuv = color.rgb2yuv(noisy)
    basic_yuv = color.rgb2yuv(basic)
    clean_yuv = color.rgb2yuv(clean)
    srch = {"noisy": noisy_yuv, "basic": basic_yuv,
            "clean": clean_yuv}[cfg.srch_img]
    ctx = search.build_search_ctx(srch, cfg)

    mask = lattice_mask(shape, cfg).copy()
    rng = np.random.default_rng(seed)
    bsize = cfg.bsize
    n_batches = max(1, -(-int(mask.sum()) // bsize))

    deno = jnp.zeros((t_len * h * w, c), jnp.float32)
    weights = jnp.zeros((t_len * h * w,), jnp.float32)

    for _ in range(n_batches):
        coords = np.argwhere(mask)
        if coords.shape[0] == 0:
            break
        if rand:
            pick = rng.permutation(coords.shape[0])[:bsize]
            sites_np = coords[pick]
        else:
            sites_np = coords[:bsize]
        n_real = sites_np.shape[0]
        if n_real < bsize:                        # pad to the static shape
            sites_np = np.concatenate(
                [sites_np, np.tile(sites_np[:1], (bsize - n_real, 1))])
        valid_np = np.arange(bsize) < n_real
        sites = jnp.asarray(sites_np.astype(np.int32))

        vals, inds = search.exec_search(srch, sites, fflow, bflow, cfg,
                                        ctx=ctx)
        pnoisy = gather.fill_patches(noisy_yuv, inds, cfg.pt, cfg.ps)
        if cfg.deno == "bayes":
            if cfg.step == 1:
                pbasic = gather.fill_patches(basic_yuv, inds, cfg.pt, cfg.ps)
                flags = (flat.flat_areas(pnoisy, cfg.gamma, cfg.sigma2)
                         if cfg.flat_areas
                         else jnp.zeros((bsize,), bool))
                pfilt, _ = bayes.bayes_denoise(pnoisy, pbasic, flags, cfg)
            else:
                pfilt, _ = bayes.bayes_denoise(pnoisy, None, None, cfg)
        else:
            pfilt = bayes.ave_denoise(pnoisy)

        valid = jnp.asarray(valid_np)
        deno, weights = agg.agg_patches(deno, weights, pfilt, inds, valid,
                                        cfg.pt, cfg.ps, shape)

        _update_mask(mask, np.asarray(inds), valid_np, shape,
                     boost=cfg.aggre_boost, nkeep=cfg.nkeep)

    fallback = basic_yuv if cfg.step == 1 else noisy_yuv
    out_yuv = agg.finalize(deno, weights, fallback, shape)
    return color.yuv2rgb(out_yuv)


def denoise_compat(noisy, sigma: float, flows=None, clean=None,
                   preset: str = "iphone",
                   cfg: Optional[VnlbConfig] = None, seed: int = 0
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Two-pass VNLB in the reference's random-masked processing order."""
    from .api import _prep_flows

    cfg = cfg or default_config(sigma, preset=preset)
    fflow, bflow, _ = _prep_flows(noisy.shape, flows)
    basic = proc_nl_compat(noisy, None, clean, fflow, bflow, cfg.stage(0),
                           seed=seed)
    deno = proc_nl_compat(noisy, basic, clean, fflow, bflow, cfg.stage(1),
                          seed=seed + 1)
    return deno, basic
