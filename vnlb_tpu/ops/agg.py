"""Overlap-aware patch aggregation (scatter-add) + weight accumulation.

The reference round-trips every batch to the host and runs a serial numba
loop (lib/vnlb/agg/comp_agg.py:82-141, the pipeline's biggest self-inflicted
bottleneck per SURVEY.md §3.5).  Here aggregation is a single on-device
scatter-add.  On the CPU XLA combines duplicate rows in a fixed order, so
repeat runs are bitwise identical (the determinism test relies on this); on
the GPU the f32 scatter-add uses atomics, and two runs of the 480p bench
differ in the last bits (ROADMAP B2).

Every (group, k) patch deposits its (pt, c, ps, ps) pixels at the decoded
corner; weights count contributions per pixel.  Invalid entries contribute
zero through the ``valid`` mask instead of control flow.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("pt", "ps", "shape"))
def agg_patches(deno: jnp.ndarray, weights: jnp.ndarray,
                patches: jnp.ndarray, inds: jnp.ndarray, valid: jnp.ndarray,
                pt: int, ps: int, shape: Tuple[int, int, int, int]
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Accumulate patch groups.

    Args:
      deno:    (T*H*W, C) accumulator (flattened spatial rows).
      weights: (T*H*W,)   contribution counts.
      patches: (B, K, pt, C, ps, ps) filtered patches.
      inds:    (B, K) int32 flat indices (t*(C*H*W) + y*W + x), -1 invalid.
      valid:   (B, K) or (B,) bool.
      shape:   (T, C, H, W) static video shape.

    Returns updated (deno, weights).
    """
    t_len, c, h, w = shape
    b, k = inds.shape
    chw = c * h * w
    hw = h * w

    if valid.ndim == 1:
        valid = valid[:, None] & (inds >= 0)
    else:
        valid = valid & (inds >= 0)

    safe = jnp.maximum(inds, 0)
    f = jnp.clip(safe // chw, 0, t_len - pt)
    y = jnp.clip((safe % hw) // w, 0, h - ps)
    x = jnp.clip(safe % w, 0, w - ps)

    dt = jnp.arange(pt, dtype=jnp.int32)
    dy = jnp.arange(ps, dtype=jnp.int32)
    dx = jnp.arange(ps, dtype=jnp.int32)
    # rows (B, K, pt, ps, ps) into the flattened (T*H*W) grid
    rows = ((f[..., None, None, None] + dt[:, None, None]) * hw
            + (y[..., None, None, None] + dy[None, :, None]) * w
            + (x[..., None, None, None] + dx[None, None, :]))

    vmask = valid[..., None, None, None].astype(patches.dtype)
    updates = jnp.transpose(patches, (0, 1, 2, 4, 5, 3))      # (B,K,pt,ps,ps,C)
    updates = updates * vmask[..., None]
    wupd = jnp.broadcast_to(vmask, rows.shape)

    rows_flat = rows.reshape(-1)
    deno = deno.at[rows_flat].add(
        updates.reshape(-1, c), mode="drop")
    weights = weights.at[rows_flat].add(
        wupd.reshape(-1), mode="drop")
    return deno, weights


# ---------------------------------------------------------------------------
# im2col ("patch-column") fast path: scatter contiguous patch ROWS into the
# column-space accumulator during the scan, fold densely once at pass end.
# Row scatters have ~100x fewer scatter indices than per-pixel scatters
# (B*K*pt rows of C*ps*ps floats instead of B*K*pt*ps*ps rows of C floats),
# and a scatter's cost grows with its index count.
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=())
def agg_rows(acc: jnp.ndarray, patches: jnp.ndarray,
             rows: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Accumulate patch rows.

    acc:   (N, pt*D+1) column-space accumulator — pt*D patch lanes (the pt
           temporal patch planes ride ONE row: plane j's lanes semantically
           belong to row base + j*H'*W' and are shifted back at fold time)
           plus ONE weight-count lane.  Fusing the pt planes and the
           weight count into a single row cuts the scatter's index count
           pt+1 -fold vs per-plane rows with a separate weight scatter.
    patches: (B, K, pt, C, ps, ps) filtered patches.
    rows:  (B, K) BASE row indices (plane 0 of gather.inds_to_rows).
    valid: (B,) or (B, K) — bool validity OR float per-patch aggregation
           weights (0 = excluded; the weight lane then accumulates the
           weight mass and finalize's division yields the weighted mean).
    """
    b, k = rows.shape
    ptd = acc.shape[1] - 1
    if valid.ndim == 1:
        valid = valid[:, None]
    vm = valid[:, :, None].astype(patches.dtype)
    upd = jnp.concatenate(
        [patches.reshape(b, k, ptd) * vm, vm], axis=-1)
    rows_flat = rows.reshape(-1)
    return acc.at[rows_flat].add(upd.reshape(-1, ptd + 1), mode="drop")


def _box_full(x: jnp.ndarray, ps: int) -> jnp.ndarray:
    """FULL-padding ps x ps box sum over the last two dims:
    out[Y, X] = sum_{dy, dx} x[Y-dy, X-dx] (zero outside) via cumsum
    differences.  Exact for integer-valued f32 inputs (plain counts stay
    below 2^24); for fractional weights (agg_weight='exp') it only
    reorders the 49-term fp sum."""
    xr = jnp.pad(x, ((0, 0), (0, ps - 1), (0, ps - 1)))
    cr = jnp.cumsum(xr, axis=-1)
    cr = jnp.concatenate([cr[..., :ps], cr[..., ps:] - cr[..., :-ps]],
                         axis=-1)
    cc = jnp.cumsum(cr, axis=-2)
    return jnp.concatenate([cc[..., :ps, :],
                            cc[..., ps:, :] - cc[..., :-ps, :]], axis=-2)


@functools.partial(jax.jit, static_argnames=("pt", "ps", "shape"))
def fold(acc: jnp.ndarray, pt: int, ps: int, shape
         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fold the column-space accumulator back to image space.

    acc (N, pt*C*ps*ps + 1) with N = T*H'*W' (lane block j = temporal patch
    plane j, scattered at the plane-0 base row; last lane = weight counts,
    see agg_rows) -> deno (T, C, H, W), weights (T, H, W).

    SEPARABLE two-stage fold as FUSED PAD-SUMS: stage A sums the ps
    dy-offsets into a (T, C, ps_dx, H, W') buffer, stage B applies the ps
    remaining dx shifts.  Each stage is one ``sum(pad(term))`` expression —
    XLA fuses the ps pads + adds into a single pass — where the previous
    ``.at[off:off+n].add`` chain was ps SERIALIZED read-modify-write passes
    over the ~170 MB stage buffer (one-hot and grouped-conv col2im
    variants were slower still on the accelerator it was first tuned on;
    GPU costs not measured).
    Addend sets are unchanged and the dy/dx orders stay ascending; only
    the pt-plane combine regroups ((sum_j0) + (sum_j1) instead of
    interleaved adds) — a last-ulp fp reorder on overlap rows, same class
    as the scan-order freedoms the tests already tolerate.  The weight
    lane folds as one cumsum box sum (49 shifted adds of the same plane =
    a full-padding box filter).
    """
    t_len, c, h, w = shape
    hp, wp = h - ps + 1, w - ps + 1
    d = c * ps * ps
    wv = acc[:, -1].reshape(t_len, hp, wp)

    wfull = _box_full(wv, ps)
    deno = None
    # weight lane: sum the pt frame-shifted copies of the box-summed counts.
    # Deliberately CONCAT-shifted, not ``weights.at[j:].add(wfull[:tl])``:
    # that dynamic-update-slice-add of a cumsum-derived operand miscompiles
    # inside shard_map on XLA:CPU (jax 0.9.0) — wrong weights on every
    # sharded tile while the identical graph is correct outside shard_map
    # (minimal repro preserved in tests/test_halo.py::test_fold_in_shardmap).
    weights = wfull
    for j in range(1, pt):
        weights = weights + jnp.concatenate(
            [jnp.zeros((j, h, w), wv.dtype), wfull[:t_len - j]], axis=0)
    z4 = ((0, 0), (0, 0), (0, 0))
    for j in range(pt):
        tl = t_len - j
        a = acc[:, j * d:(j + 1) * d].reshape(t_len, hp, wp, c, ps, ps)
        a = jnp.transpose(a, (0, 3, 5, 4, 1, 2))    # (T, C, dx, dy, H', W')
        accx = None
        for dy in range(ps):
            term = jnp.pad(a[:, :, :, dy],
                           z4 + ((dy, ps - 1 - dy), (0, 0)))
            accx = term if accx is None else accx + term
        dj = None                                   # (T, C, H, W)
        for dx in range(ps):
            term = jnp.pad(accx[:, :, dx], z4[:2] + ((0, 0),
                                                     (dx, ps - 1 - dx)))
            dj = term if dj is None else dj + term
        if j:
            dj = jnp.concatenate(
                [jnp.zeros((j, c, h, w), acc.dtype), dj[:tl]], axis=0)
        deno = dj if deno is None else deno + dj
    return deno, weights


def finalize(deno_flat: jnp.ndarray, weights_flat: jnp.ndarray,
             fallback: jnp.ndarray, shape) -> jnp.ndarray:
    """Normalize by weights; zero-weight pixels fall back to basic/noisy
    (reference proc_nl.py:118-125)."""
    t_len, c, h, w = shape
    wpos = weights_flat > 0
    wsafe = jnp.where(wpos, weights_flat, 1.0)
    out = deno_flat / wsafe[:, None]
    out = out.reshape(t_len, h, w, c).transpose(0, 3, 1, 2)
    return jnp.where(wpos.reshape(t_len, 1, h, w), out, fallback)


def finalize_img(deno: jnp.ndarray, weights: jnp.ndarray,
                 fallback: jnp.ndarray) -> jnp.ndarray:
    """finalize() for image-shaped accumulators ((T,C,H,W), (T,H,W))."""
    wpos = weights > 0
    wsafe = jnp.where(wpos, weights, 1.0)
    out = deno / wsafe[:, None]
    return jnp.where(wpos[:, None], out, fallback)
