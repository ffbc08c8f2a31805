"""Patch-group gather (reference: external ``vpss.fill_patches``, called at
lib/vnlb/search/search.py:91-98; contract in SURVEY.md §2.2 N2).

Given top-K flat indices, gather the (pt, c, ps, ps) patch starting at each
decoded (t, y, x) corner.  Invalid indices (-1) gather from a clamped corner
and are expected to be masked downstream (the pipeline's validity mask), which
avoids data-dependent branching under jit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


@functools.partial(jax.jit, static_argnames=("pt", "ps"))
def fill_patches(video: jnp.ndarray, inds: jnp.ndarray, pt: int, ps: int
                 ) -> jnp.ndarray:
    """(T,C,H,W) video + (B,K) flat inds -> (B,K,pt,C,ps,ps) patches."""
    t_len, c, h, w = video.shape
    chw = c * h * w
    hw = h * w
    safe = jnp.maximum(inds, 0)
    f = jnp.clip(safe // chw, 0, t_len - pt)
    y = jnp.clip((safe % hw) // w, 0, h - ps)
    x = jnp.clip(safe % w, 0, w - ps)

    def one(fi, yi, xi):
        return lax.dynamic_slice(video, (fi, 0, yi, xi), (pt, c, ps, ps))

    return jax.vmap(jax.vmap(one))(f, y, x)


# ---------------------------------------------------------------------------
# im2col ("patch-column") fast path
#
# Gathers of tiny (ps-wide) slices are slow; instead the video is
# unfolded ONCE per pass into (T, H', W', C*ps*ps) patch columns, and patch
# groups become contiguous row gathers (aggregation scatters rows back into
# the same space — see ops/agg.py).  H' = H-ps+1, W' = W-ps+1: exactly the
# valid patch-corner grid the search produces.
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("ps",))
def im2col(video: jnp.ndarray, ps: int) -> jnp.ndarray:
    """(T, C, H, W) -> (T, H', W', C*ps*ps) patch columns."""
    t, c, h, w = video.shape
    hp, wp = h - ps + 1, w - ps + 1
    cols = [video[:, :, dy:dy + hp, dx:dx + wp]
            for dy in range(ps) for dx in range(ps)]
    cols = jnp.stack(cols, axis=-1)                     # (T, C, H', W', ps*ps)
    return jnp.transpose(cols, (0, 2, 3, 1, 4)).reshape(t, hp, wp, c * ps * ps)


@functools.partial(jax.jit, static_argnames=("ps", "bf16"))
def im2col_conv(video: jnp.ndarray, ps: int, bf16: bool = True
                ) -> jnp.ndarray:
    """im2col as ONE one-hot convolution: (T, C, H, W) -> (T, H', W',
    C*ps*ps) in bf16 (or f32).

    The slice-stack-transpose form of ``im2col`` lowers to ~150 chunked
    dynamic-update-slices plus a relayout; a VALID conv with a one-hot
    (ps, ps, C, C*ps*ps) kernel emits the same columns in one op (~90
    GFLOP at 480p; pinned bitwise on the GPU by tests/test_gpu.py).
    Values are BITWISE identical: each output element has exactly one nonzero kernel
    term, bf16 products x*1 are exact on the bf16-cast input, and the f32
    path uses HIGHEST precision (exact 3-way bf16 splitting, recombined
    losslessly for a 0/1 multiplier).
    """
    t, c, h, w = video.shape
    dty = jnp.bfloat16 if bf16 else jnp.float32
    import numpy as np_

    k = np_.zeros((ps, ps, c, c * ps * ps), np_.float32)
    for ci in range(c):
        for dy in range(ps):
            for dx in range(ps):
                k[dy, dx, ci, ci * ps * ps + dy * ps + dx] = 1.0
    x = jnp.transpose(video, (0, 2, 3, 1)).astype(dty)
    return lax.conv_general_dilated(
        x, jnp.asarray(k, dty), (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=None if bf16 else jax.lax.Precision.HIGHEST,
        preferred_element_type=dty)


@functools.partial(jax.jit, static_argnames=("ps", "pt", "bf16"))
def arena_conv(imgs, ps: int, pt: int, bf16: bool = True) -> jnp.ndarray:
    """Direct c-major pt-fused (and optionally image-joined) patch arena in
    ONE one-hot conv: [(T, C, H, W)] x nimg -> (T*H'*W', nimg*C*pt*ps*ps).

    Bitwise equal to im2col_conv -> cols_fuse_pt(c-major) -> lane concat,
    but the pt-fusion and the noisy/basic join ride the conv kernel's
    output channels instead of a roll/concat graph — XLA lowered that graph
    to ~1470 per-(frame, lane) dynamic-update-slices.  Lane order per
    image block: (ci, f_off,
    dy, dx) — gather.cols_fuse_pt's c-major order.  Rows of the last pt-1
    frames carry frame-wrapped garbage, exactly like cols_fuse_pt's roll;
    they are never addressed (inds_to_rows clips the base frame)."""
    imgs = list(imgs)
    nimg = len(imgs)
    t, c, h, w = imgs[0].shape
    d = c * ps * ps
    dty = jnp.bfloat16 if bf16 else jnp.float32
    import numpy as np_

    k = np_.zeros((ps, ps, nimg * pt * c, nimg * pt * d), np_.float32)
    for img in range(nimg):
        for f in range(pt):
            for ci in range(c):
                cin = img * pt * c + f * c + ci
                for dy in range(ps):
                    for dx in range(ps):
                        cout = (img * pt * d + ci * pt * ps * ps
                                + f * ps * ps + dy * ps + dx)
                        k[dy, dx, cin, cout] = 1.0
    planes = []
    for im in imgs:
        for f in range(pt):
            planes.append(im if f == 0 else jnp.roll(im, -f, axis=0))
    x = jnp.concatenate(planes, axis=1)                # (T, nimg*pt*C, H, W)
    x = jnp.transpose(x, (0, 2, 3, 1)).astype(dty)
    out = lax.conv_general_dilated(
        x, jnp.asarray(k, dty), (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=None if bf16 else jax.lax.Precision.HIGHEST,
        preferred_element_type=dty)
    hp, wp = h - ps + 1, w - ps + 1
    return out.reshape(t * hp * wp, nimg * pt * d)


def cols_rows(cols: jnp.ndarray):
    """Flatten (T, H', W', D) -> ((T*H'*W', D), (H', W'))."""
    t, hp, wp, d = cols.shape
    return cols.reshape(t * hp * wp, d), (hp, wp)


def inds_to_rows(inds: jnp.ndarray, shape, ps: int, pt: int) -> jnp.ndarray:
    """Decode flat image indices -> (B, K, pt) row indices into the
    flattened column space (frame f+dt, same corner)."""
    t_len, c, h, w = shape
    hp, wp = h - ps + 1, w - ps + 1
    chw = c * h * w
    hw = h * w
    safe = jnp.maximum(inds, 0)
    f = jnp.clip(safe // chw, 0, t_len - pt)
    y = jnp.clip((safe % hw) // w, 0, hp - 1)
    x = jnp.clip(safe % w, 0, wp - 1)
    base = f * (hp * wp) + y * wp + x                   # (B, K)
    dt = jnp.arange(pt, dtype=inds.dtype) * (hp * wp)
    return base[:, :, None] + dt[None, None, :]         # (B, K, pt)


@functools.partial(jax.jit, static_argnames=("pt", "ps", "c"))
def fill_patches_cols(cols_flat: jnp.ndarray, rows: jnp.ndarray,
                      pt: int, ps: int, c: int) -> jnp.ndarray:
    """Row-gather patches: (N, C*ps*ps) cols + (B, K, pt) rows ->
    (B, K, pt, C, ps, ps) in the ARENA dtype (bf16 arenas stay bf16: the
    consumer — bayes centering / flat stats — upcasts AFTER its layout
    transpose, halving the transpose traffic; the bf16->f32 cast is exact,
    so results are bitwise unchanged)."""
    b, k, _ = rows.shape
    d = c * ps * ps
    out = jnp.take(cols_flat, rows.reshape(-1), axis=0)[:, :d]
    return out.reshape(b, k, pt, c, ps, ps)


def cols_fuse_pt(cols_flat: jnp.ndarray, pt: int, hpwp: int,
                 c: int = 0) -> jnp.ndarray:
    """(N, D) -> (N, pt*D): row r additionally carries rows r + j*hpwp
    (the SAME patch corner in the next pt-1 frames), so a pt-frame patch
    becomes ONE row gather instead of pt — a take's cost grows with its
    row count, so halving the row count (pt=2) cuts the gather bill for the
    price of a pt x larger (dense-built) arena.  Rows whose shifted source
    runs past the last frame are never addressed (inds_to_rows clips the
    base frame to T-pt).

    ``c > 0`` selects the C-MAJOR lane order (c, pt, ps*ps) instead of
    (pt, c, ps*ps): the Bayes filter groups per channel, so c-major rows
    reach its (B, c, K, p) layout by moving CONTIGUOUS p-lane blocks —
    the pt-major order made that transpose shuffle ps*ps-lane fragments.
    The aggregation accumulator keeps its own
    (pt, c, ps*ps) lane order; arena and accumulator never meet."""
    if pt == 1:
        return cols_flat
    planes = [cols_flat] + [jnp.roll(cols_flat, -j * hpwp, axis=0)
                            for j in range(1, pt)]
    if not c:
        return jnp.concatenate(planes, axis=1)
    pp = cols_flat.shape[1] // c
    return jnp.concatenate(
        [pl[:, ci * pp:(ci + 1) * pp] for ci in range(c) for pl in planes],
        axis=1)


@functools.partial(jax.jit, static_argnames=("pt", "ps", "c"))
def fill_patches_cols_fused(cols_pt: jnp.ndarray, rows_base: jnp.ndarray,
                            pt: int, ps: int, c: int) -> jnp.ndarray:
    """fill_patches_cols on a C-MAJOR pt-fused arena (cols_fuse_pt with
    c > 0): rows_base (B, K) plane-0 row indices -> (B, K, c, pt*ps*ps)
    rows in the arena dtype (see fill_patches_cols on why bf16 is NOT
    upcast here).  The (c, p) lane split is a pure reshape."""
    b, k = rows_base.shape
    d = c * ps * ps
    out = jnp.take(cols_pt, rows_base.reshape(-1), axis=0)[:, :pt * d]
    return out.reshape(b, k, c, pt * ps * ps)


@functools.partial(jax.jit, static_argnames=("pt", "ps", "c"))
def fill_patches_cols_joint(cols_join: jnp.ndarray, rows_base: jnp.ndarray,
                            pt: int, ps: int, c: int):
    """One take over a lane-JOINED pair of c-major pt-fused arenas
    (noisy ++ basic): gathering both step-2 arenas from a (N, 2*pt*D)
    concat at the same rows halves the take's row count vs two takes.
    Returns (pnoisy, pbasic), each (B, K, c, pt*ps*ps) in the arena
    dtype."""
    b, k = rows_base.shape
    d = c * ps * ps
    out = jnp.take(cols_join, rows_base.reshape(-1), axis=0)

    def part(j):
        block = out[:, j * pt * d:(j + 1) * pt * d]
        return block.reshape(b, k, c, pt * ps * ps)

    return part(0), part(1)
