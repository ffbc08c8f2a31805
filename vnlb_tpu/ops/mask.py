"""Coverage lattice: which pixel sites get a patch-group processed.

The reference builds an int8 mask with a numba kernel (reference:
lib/vnlb/search_mask/mask.py:315-358 ``fill_mask``) and then *randomly* draws
batches from it (mask.py:18-31 ``mask2inds``), removing processed sites and
their matches each step (mask.py:37-86).  Random draws force a host sync per
batch and make the output order-dependent.

Redesign (SURVEY.md §7.1): the lattice is a pure function of the
video shape and the stage config, so we enumerate it **densely at trace time**
with vectorized numpy, in raster (t, h, w) order, and process every lattice
site in fixed-size batches inside one ``lax.scan``.  This is deterministic,
host-sync-free, and jit-compatible.  The semantics of the strided,
phase-shifted grid (step ``procStep``, per-frame/row phase shifts, always-on
border rows/cols) are reproduced exactly.
"""

from __future__ import annotations

import numpy as np

from ..config import StageConfig


def lattice_mask(shape, cfg: StageConfig, t_origin: int = 0) -> np.ndarray:
    """Boolean (t, h, w) coverage mask.

    Exact vectorization of the reference recurrence (mask.py:315-358) for the
    whole-video case (origins at 0, no tile borders):

      * frames:   every frame in [0, t-pt+1) (step_t == 1), with the last
                  valid frame treated as phase 0;
      * rows:     ``dh % step == phase_h % step`` where ``phase_h = ti`` (or 0
                  on the last frame), plus the first and last valid rows;
      * columns:  ``dw % step == phase_w % step`` where
                  ``phase_w = phase_h + hi//step`` (or 0 on the last valid
                  row), plus the first and last valid columns.

    ``t_origin`` offsets the per-frame phases: a temporal sub-window of a
    longer video (api.denoise_streaming) passes its global start frame so
    the window's lattice coincides with the monolithic run's for every
    shared frame (the last-window-frame phase-0 special case still differs
    mid-video, but its sites sit >= nwt+pt-1 frames outside the chunk's
    output range under the streaming context accounting, so their
    contributions never reach an emitted frame).
    """
    t, c, h, w = shape
    ps, pt, step = cfg.ps, cfg.pt, cfg.step_s
    end_t = t - pt + 1
    end_h = h - ps + 1
    end_w = w - ps + 1
    if end_t <= 0 or end_h <= 0 or end_w <= 0:
        raise ValueError(f"video {shape} smaller than patch ({pt},{ps},{ps})")

    ti = np.arange(end_t)[:, None, None]            # (T', 1, 1)
    hi = np.arange(end_h)[None, :, None]            # (1, H', 1)
    wi = np.arange(end_w)[None, None, :]            # (1, 1, W')

    last_t = ti == (end_t - 1)
    phase_h = np.where(last_t, 0, ti + t_origin)    # (T',1,1)

    take_h = (hi % step) == (phase_h % step)
    first_h = hi == 0
    last_h = hi == (end_h - 1)
    row_on = take_h | first_h | last_h

    phase_w = np.where(last_h, 0, phase_h + hi // step)
    take_w = (wi % step) == (phase_w % step)
    first_w = wi == 0
    last_w = wi == (end_w - 1)
    col_on = take_w | first_w | last_w

    core = row_on & col_on                          # (T', H', W')
    mask = np.zeros((t, h, w), dtype=bool)
    mask[:end_t, :end_h, :end_w] = core
    return mask


def lattice_sites(shape, cfg: StageConfig, t_origin: int = 0) -> np.ndarray:
    """(S, 3) int32 site coordinates in raster (t, h, w) order."""
    mask = lattice_mask(shape, cfg, t_origin)
    sites = np.argwhere(mask).astype(np.int32)
    return sites


def interior_split(sites: np.ndarray, shape, cfg: StageConfig):
    """Split sites into (interior, border) for the dense zero-flow search.

    Interior = the FULL-RESOLUTION search window never clamps (candidates
    are then pure translations of the site).  Coarse needle-pyramid levels
    may still clamp near borders; the dense path anchors the coarse query
    at the clamped window center there (a <= half-pixel coarse-level offset
    on an additive coarse term — see ops/search_dense._site_rows), which
    keeps ~96% of sites on the fast path instead of ~75%.  Static numpy:
    the site list is a compile-time constant per video shape.
    """
    t, c, h, w = shape
    ps, w_s = cfg.ps, cfg.w_s
    half = (w_s - 1) // 2
    ys, xs = sites[:, 1], sites[:, 2]
    ok = ((ys >= half) & (ys <= h - ps - half)
          & (xs >= half) & (xs <= w - ps - half))
    return sites[ok], sites[~ok]


def batched_sites(shape, cfg: StageConfig, bsize: int | None = None,
                  t_origin: int = 0):
    """Pad the site list to a multiple of the batch size and reshape.

    Returns (site_batches (NB, B, 3) int32, valid (NB, B) bool).  Padded rows
    repeat site 0 and are masked out of aggregation by ``valid``.
    """
    bsize = bsize or cfg.bsize
    sites = lattice_sites(shape, cfg, t_origin)
    s = sites.shape[0]
    nb = max(1, -(-s // bsize))
    pad = nb * bsize - s
    valid = np.ones((s,), dtype=bool)
    if pad:
        sites = np.concatenate([sites, np.tile(sites[:1], (pad, 1))], axis=0)
        valid = np.concatenate([valid, np.zeros((pad,), dtype=bool)])
    return sites.reshape(nb, bsize, 3), valid.reshape(nb, bsize)
