"""Pyramidal optical flow estimators (jittable, static shapes).

The reference obtained TV-L1 flow from the external SWIG C++ package
(``svnlb.swig.runPyFlow``, reference tests/test_gpu_sim_search.py:125-128)
and only *plumbed* flows through the pipeline.  This module closes that gap
with in-repo estimators so ``denoise(noisy, sigma, flows=estimate_flows(
noisy))`` is self-contained.  Two methods:

* ``tvl1_flow`` — duality-based TV-L1 (Zach/Pock/Bischof 2007, the
  Sanchez et al. IPOL 2013 formulation): THE algorithm the reference's
  external flow package implements.  Per pyramid level, a few warps of the
  moving frame; per warp, a fixed number of primal-dual iterations — a
  pointwise residual thresholding step and a dual TV ascent with forward
  differences / divergence.  Everything is elementwise + 1-px stencils on
  static shapes (jit friendly); the published stopping criterion is
  replaced by a fixed iteration count (data-independent control flow).
* ``lk_flow`` — dense iterative Lucas-Kanade (upsample, warp, a few
  Gauss-Newton steps on per-pixel 2x2 box-window normal equations).
  ~5x cheaper; quality is close on smooth motion.

Default method for ``estimate_flows`` is TV-L1 (reference parity);
measured on the drift clip both beat zero flow (tests/test_flow_benefit).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _avg_pool(x):
    h2, w2 = x.shape[-2] // 2, x.shape[-1] // 2
    v = x[..., :h2 * 2, :w2 * 2]
    v = v.reshape(x.shape[:-2] + (h2, 2, w2, 2))
    return v.mean(axis=(-3, -1))


def _box(x, r):
    """(H, W) box mean of radius r via cumsum (same-size, edge-padded)."""
    k = 2 * r + 1
    xp = jnp.pad(x, r, mode="edge")
    c = jnp.cumsum(xp, axis=0)
    c = jnp.concatenate([c[k - 1:k], c[k:] - c[:-k]], axis=0)
    c2 = jnp.cumsum(c, axis=1)
    c2 = jnp.concatenate([c2[:, k - 1:k], c2[:, k:] - c2[:, :-k]], axis=1)
    return c2 / (k * k)


def _warp(img, u, v):
    """Bilinear warp: sample img at (y + v, x + u)."""
    h, w = img.shape
    yy = jnp.arange(h, dtype=jnp.float32)[:, None] + v
    xx = jnp.arange(w, dtype=jnp.float32)[None, :] + u
    y0 = jnp.clip(jnp.floor(yy), 0, h - 2)
    x0 = jnp.clip(jnp.floor(xx), 0, w - 2)
    fy = jnp.clip(yy - y0, 0.0, 1.0)
    fx = jnp.clip(xx - x0, 0.0, 1.0)
    y0 = y0.astype(jnp.int32)
    x0 = x0.astype(jnp.int32)
    g = img[y0, x0] * (1 - fy) * (1 - fx) + img[y0, x0 + 1] * (1 - fy) * fx \
        + img[y0 + 1, x0] * fy * (1 - fx) + img[y0 + 1, x0 + 1] * fy * fx
    return g


def _lk_level(i0, i1, u, v, radius, iters, eps):
    gy, gx = jnp.gradient(i0)
    gxx = _box(gx * gx, radius) + eps
    gyy = _box(gy * gy, radius) + eps
    gxy = _box(gx * gy, radius)
    det = gxx * gyy - gxy * gxy

    def step(_, uv):
        u, v = uv
        it = _warp(i1, u, v) - i0
        bx = _box(gx * it, radius)
        by = _box(gy * it, radius)
        du = (gyy * bx - gxy * by) / det
        dv = (gxx * by - gxy * bx) / det
        return (u - du, v - dv)

    u, v = jax.lax.fori_loop(0, iters, step, (u, v))
    return u, v


@functools.partial(jax.jit, static_argnames=("levels", "radius", "iters"))
def lk_flow(frame0: jnp.ndarray, frame1: jnp.ndarray, levels: int = 3,
            radius: int = 4, iters: int = 3) -> jnp.ndarray:
    """Flow from frame0 to frame1; (c, h, w) frames -> (2, h, w) (u, v)."""
    g0 = jnp.mean(jnp.asarray(frame0, jnp.float32), axis=0) / 255.0
    g1 = jnp.mean(jnp.asarray(frame1, jnp.float32), axis=0) / 255.0
    pyr = [(g0, g1)]
    for _ in range(1, levels):
        if min(pyr[-1][0].shape) < 2 * (2 * radius + 1):
            break
        pyr.append((_avg_pool(pyr[-1][0]), _avg_pool(pyr[-1][1])))

    u = jnp.zeros_like(pyr[-1][0])
    v = jnp.zeros_like(pyr[-1][0])
    for lvl in range(len(pyr) - 1, -1, -1):
        a, b = pyr[lvl]
        if u.shape != a.shape:
            u = 2.0 * jax.image.resize(u, a.shape, "bilinear")
            v = 2.0 * jax.image.resize(v, a.shape, "bilinear")
        u, v = _lk_level(a, b, u, v, radius, iters, 1e-4)
    return jnp.stack([u, v])


# ---------------------------------------------------------------------------
# TV-L1 (Zach/Pock/Bischof 2007; Sanchez et al. IPOL 2013 parameterization).
# The reference's flow source (svnlb's C++ tvl1flow) implements this same
# published algorithm; this is an independent jittable implementation.
# ---------------------------------------------------------------------------


def _blur121(x):
    """Separable [1,4,6,4,1]/16 binomial blur (~Gaussian sigma 1), edge-pad."""
    k = jnp.asarray([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    xp = jnp.pad(x, ((2, 2), (0, 0)), mode="edge")
    x = sum(k[i] * xp[i:i + x.shape[0]] for i in range(5))
    xp = jnp.pad(x, ((0, 0), (2, 2)), mode="edge")
    return sum(k[i] * xp[:, i:i + x.shape[1]] for i in range(5))


def _fgrad(x):
    """Forward differences, zero at the last row/col (Neumann)."""
    gx = jnp.pad(x[:, 1:] - x[:, :-1], ((0, 0), (0, 1)))
    gy = jnp.pad(x[1:] - x[:-1], ((0, 1), (0, 0)))
    return gx, gy


def _div(px, py):
    """Divergence = -adjoint of ``_fgrad`` (standard TV discretization)."""
    dx = jnp.concatenate(
        [px[:, :1], px[:, 1:-1] - px[:, :-2], -px[:, -2:-1]], axis=1)
    dy = jnp.concatenate(
        [py[:1], py[1:-1] - py[:-2], -py[-2:-1]], axis=0)
    return dx + dy


def _tvl1_level(i0, i1, u1, u2, lam, theta, tau, warps, iters):
    """One pyramid level of duality-based TV-L1 (fixed iteration counts)."""
    l_t = lam * theta
    i1y, i1x = jnp.gradient(i1)  # gradient returns (d/dy, d/dx)
    p11 = jnp.zeros_like(u1)
    p12, p21, p22 = p11, p11, p11

    def one_warp(_, state):
        u1, u2, p11, p12, p21, p22 = state
        # warp the moving frame and its gradient by the CURRENT flow; the
        # linearized residual rho(u) = I1w + <grad I1w, u - u0> - I0 stays
        # anchored at u0 for all inner iterations of this warp
        i1w = _warp(i1, u1, u2)
        i1wx = _warp(i1x, u1, u2)
        i1wy = _warp(i1y, u1, u2)
        grad = i1wx * i1wx + i1wy * i1wy
        rho_c = i1w - i1wx * u1 - i1wy * u2 - i0

        def inner(_, st):
            u1, u2, p11, p12, p21, p22 = st
            rho = rho_c + i1wx * u1 + i1wy * u2
            # pointwise minimizer of the data-attachment proximal step
            d = -rho / jnp.maximum(grad, 1e-9)
            mag = jnp.clip(d, -l_t, l_t)  # |step| capped at lam*theta
            v1 = u1 + mag * i1wx
            v2 = u2 + mag * i1wy
            # primal update from the dual TV field, then dual ascent
            u1n = v1 + theta * _div(p11, p12)
            u2n = v2 + theta * _div(p21, p22)
            g11, g12 = _fgrad(u1n)
            g21, g22 = _fgrad(u2n)
            tt = tau / theta
            n1 = 1.0 + tt * jnp.sqrt(g11 * g11 + g12 * g12)
            n2 = 1.0 + tt * jnp.sqrt(g21 * g21 + g22 * g22)
            return (u1n, u2n, (p11 + tt * g11) / n1, (p12 + tt * g12) / n1,
                    (p21 + tt * g21) / n2, (p22 + tt * g22) / n2)

        return jax.lax.fori_loop(0, iters, inner,
                                 (u1, u2, p11, p12, p21, p22))

    state = jax.lax.fori_loop(0, warps, one_warp,
                              (u1, u2, p11, p12, p21, p22))
    return state[0], state[1]


@functools.partial(jax.jit, static_argnames=("levels", "warps", "iters"))
def tvl1_flow(frame0: jnp.ndarray, frame1: jnp.ndarray, levels: int = 5,
              lam: float = 0.15, theta: float = 0.3, tau: float = 0.25,
              warps: int = 5, iters: int = 25) -> jnp.ndarray:
    """TV-L1 flow frame0 -> frame1; (c, h, w) frames -> (2, h, w) (u, v).

    Parameters follow the published defaults (lam 0.15 on the [0,255]
    intensity scale, theta 0.3, tau 0.25, 5 warps); ``iters`` fixes the
    inner primal-dual count in place of the data-dependent stopping rule.
    """
    g0 = jnp.mean(jnp.asarray(frame0, jnp.float32), axis=0)
    g1 = jnp.mean(jnp.asarray(frame1, jnp.float32), axis=0)
    g0, g1 = _blur121(g0), _blur121(g1)
    pyr = [(g0, g1)]
    for _ in range(1, levels):
        if min(pyr[-1][0].shape) < 16:
            break
        pyr.append((_avg_pool(_blur121(pyr[-1][0])),
                    _avg_pool(_blur121(pyr[-1][1]))))

    u = jnp.zeros_like(pyr[-1][0])
    v = jnp.zeros_like(pyr[-1][0])
    for lvl in range(len(pyr) - 1, -1, -1):
        a, b = pyr[lvl]
        if u.shape != a.shape:
            u = 2.0 * jax.image.resize(u, a.shape, "bilinear")
            v = 2.0 * jax.image.resize(v, a.shape, "bilinear")
        u, v = _tvl1_level(a, b, u, v, lam, theta, tau, warps, iters)
    return jnp.stack([u, v])


def estimate_flows(video, levels: int = 3, radius: int = 4, iters: int = 3,
                   method: str = "tvl1"):
    """(T, c, h, w) video -> (fflow, bflow) each (T, 2, h, w).

    fflow[i] maps frame i -> i+1 (last repeated); bflow[i] maps i -> i-1
    (first repeated) — the layout ``denoise(..., flows=)`` expects.
    ``method``: "tvl1" (reference-parity duality-based TV-L1, default) or
    "lk" (pyramidal Lucas-Kanade, ~5x cheaper).  LK honors
    ``levels/radius/iters``; TV-L1 uses its published defaults.
    """
    video = jnp.asarray(video, jnp.float32)
    t = video.shape[0]
    if method == "tvl1":
        f = tvl1_flow
    elif method == "lk":
        f = functools.partial(lk_flow, levels=levels, radius=radius,
                              iters=iters)
    else:
        raise ValueError(f"unknown flow method [{method}]")
    fwd = [f(video[i], video[i + 1]) for i in range(t - 1)]
    bwd = [f(video[i + 1], video[i]) for i in range(t - 1)]
    fflow = jnp.stack(fwd + [fwd[-1]]) if fwd else jnp.zeros((1, 2) + video.shape[2:])
    bflow = jnp.stack([bwd[0]] + bwd) if bwd else jnp.zeros((1, 2) + video.shape[2:])
    return fflow, bflow
