"""Correctness checks shared by the GPU tests (tests/test_gpu.py) and
chip_smoke.py: each compares a production fast path with its plain
reference on the same input and returns what it found, leaving the verdict
to the caller.
"""

from __future__ import annotations

import numpy as np

from ..config import StageConfig, default_config


def smoke_clip(t: int = 5, h: int = 480, w: int = 854, sigma: float = 20.0,
               seed: int = 0):
    """Seeded synthetic DAVIS-class clip: (clean, noisy), (T, 3, H, W)."""
    from .data import add_noise, synthetic_video

    clean = synthetic_video(t, h, w, seed=seed)
    return clean, add_noise(clean, sigma, seed=seed + 1)


def bench_config(sigma: float = 20.0, **overrides):
    """The benchmark configuration: poly filter, stride 6, masked borders."""
    kw = dict(eig_method="poly", step_s=6, border_mode="mask")
    kw.update(overrides)
    return default_config(sigma, preset="iphone", **kw)


def lattice_phases(shape, cfg: StageConfig, t_origin: int = 0):
    """Per-frame coverage-lattice row phases, as pipeline.proc_nl passes
    them to the strided search."""
    end_t = shape[0] - cfg.pt + 1
    return tuple(((f + t_origin) % cfg.step_s) if f < end_t - 1 else 0
                 for f in range(end_t))


def strided_parity(video_yuv, cfg: StageConfig) -> dict:
    """Strided-query search (lattice layouts) vs the all-pixels search
    (``dense_rows="full"``) over every lattice site of ``video_yuv``.

    Returns values_equal / inds_equal (bitwise), max_rel (largest relative
    value difference over finite entries) and idx_agree (share of equal
    top-K indices)."""
    import jax.numpy as jnp

    from ..ops.mask import lattice_sites
    from ..ops.search_dense import exec_search_dense

    shape = tuple(video_yuv.shape)
    v = jnp.asarray(video_yuv)
    s = jnp.asarray(lattice_sites(shape, cfg))
    fv, fi = exec_search_dense(v, s, cfg.replace(dense_rows="full"))
    sv, si = exec_search_dense(v, s, cfg, qrow0=lattice_phases(shape, cfg))
    fv, fi, sv, si = map(np.asarray, (fv, fi, sv, si))
    fin = np.isfinite(fv) & np.isfinite(sv)
    rel = np.abs(sv - fv) / np.maximum(np.abs(fv), 1e-6)
    return dict(values_equal=bool(np.array_equal(sv, fv)),
                inds_equal=bool(np.array_equal(si, fi)),
                max_rel=float(rel[fin].max()) if fin.any() else 0.0,
                idx_agree=float((si == fi).mean()),
                n_sites=int(s.shape[0]))


def arena_exact(noisy_yuv, basic_yuv, ps: int = 7, pt: int = 2) -> dict:
    """The one-hot-convolution patch arenas vs the plain slice form.

    im2col_conv (bf16 and f32) against ``gather.im2col``, and the joined
    pt-fused ``arena_conv`` against im2col -> cols_fuse_pt(c-major) ->
    lane concat.  Returns one bitwise-equality flag per form."""
    import jax.numpy as jnp

    from ..ops import gather

    n = jnp.asarray(noisy_yuv)
    b = jnp.asarray(basic_yuv)
    t, c, h, w = n.shape
    hpwp = (h - ps + 1) * (w - ps + 1)
    d = c * ps * ps
    out = {}
    for name, bf16 in (("bf16", True), ("f32", False)):
        dty = jnp.bfloat16 if bf16 else jnp.float32
        ref_n = gather.im2col(n.astype(dty), ps)
        got = gather.im2col_conv(n, ps, bf16=bf16)
        out[f"im2col_conv_{name}"] = bool(jnp.array_equal(got, ref_n))
        ref_b = gather.im2col(b.astype(dty), ps)
        fused = [gather.cols_fuse_pt(r.reshape(t * hpwp, d), pt, hpwp, c)
                 for r in (ref_n, ref_b)]
        ref = jnp.concatenate(fused, axis=1)
        got = gather.arena_conv([n, b], ps, pt, bf16=bf16)
        out[f"arena_conv_{name}"] = bool(jnp.array_equal(got, ref))
    return out
