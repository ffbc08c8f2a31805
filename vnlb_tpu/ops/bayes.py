"""Empirical-Bayes (Wiener) patch-group filter.

Reference semantics (lib/vnlb/deno/bayes_est.py:17-151), re-expressed as one
fused XLA region over the ``(groups * channels)`` batch axis:

  1. reshape (B, K, pt, c, ps, ps) -> (B, c, K, p), p = pt*ps*ps;
  2. center: noisy groups by their own mean — except *flat* groups in step 2,
     which are centered on the basic mean (bayes_est.py:88-104);
  3. covariance of the ``cpatches`` source group: C = X^T X / K;
  4. batched symmetric eigendecomposition (jnp.linalg.eigh — the XLA
     counterpart of the reference's cuSOLVER syevd, SURVEY.md §2.2 N7),
     eigenvalues descending, top ``rank`` eigenvectors kept;
  5. "clipped" shrinkage: lam -= min(lam, sigma_basic^2) on the top-rank
     eigenvalues (bayes_est.py:129-138);
  6. Wiener coefficients: w = 1/(1 + sigma^2/lam) if lam > thresh*sigma^2
     else 0 (bayes_est.py:140-144);
  7. project: Xhat = (X U_r) (U_r * w)^T, re-add centers.

Returns the filtered noisy patches and ``rank_var`` (the pre-shrinkage
eigenvalue mass, reference bayes_est.py:39-40).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import StageConfig

_HI = jax.lax.Precision.HIGHEST


def _to_bcnp(p: jnp.ndarray) -> jnp.ndarray:
    """Patches -> (B, c, K, p) group layout.

    Accepts EITHER the public 6-D (B, K, pt, c, ps, ps) layout (transpose
    shuffles ps*ps-lane fragments) or c-major 4-D rows (B, K, c, p) from
    the fused arenas (gather.cols_fuse_pt c-major order) whose transpose
    moves contiguous p-lane blocks instead of ps*ps-wide fragments."""
    if p.ndim == 4:
        return jnp.transpose(p, (0, 2, 1, 3))
    b, k, pt, c, ps, _ = p.shape
    return jnp.transpose(p, (0, 3, 1, 2, 4, 5)).reshape(b, c, k, pt * ps * ps)


def _from_bcnp(x: jnp.ndarray, pt: int, ps: int) -> jnp.ndarray:
    b, c, k, _ = x.shape
    x = x.reshape(b, c, k, pt, ps, ps)
    return jnp.transpose(x, (0, 2, 3, 1, 4, 5))


def bayes_denoise(pnoisy: jnp.ndarray, pbasic: Optional[jnp.ndarray],
                  flat: Optional[jnp.ndarray], cfg: StageConfig
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Filter noisy patch groups; returns (filtered, rank_var).

    pnoisy/pbasic: (B, K, pt, c, ps, ps) public layout, or c-major
    (B, K, c, pt*ps*ps) rows (see _to_bcnp); flat: (B,) bool or None.
    The filtered output is ALWAYS the public 6-D layout.
    """
    if pnoisy.ndim == 4:
        b, k, c, p = pnoisy.shape
        pt, ps = cfg.pt, cfg.ps
    else:
        b, k, pt, c, ps, _ = pnoisy.shape
        p = pt * ps * ps
    rank = min(cfg.rank, p)
    step2 = cfg.step == 1

    # layout transpose in the INPUT dtype (bf16 arena rows halve the
    # transpose traffic), exact upcast to f32 right after
    xn = _to_bcnp(pnoisy).astype(jnp.float32)               # (B, c, K, p)
    cnoisy = jnp.mean(xn, axis=2, keepdims=True)            # (B, c, 1, p)

    if step2:
        assert pbasic is not None and flat is not None
        xb = _to_bcnp(pbasic).astype(jnp.float32)
        cbasic = jnp.mean(xb, axis=2, keepdims=True)
        cnoisy = jnp.where(flat[:, None, None, None], cbasic, cnoisy)
        xb = xb - cbasic
    xn = xn - cnoisy

    if cfg.cpatches == "noisy":
        xc = xn
    elif cfg.cpatches == "basic":
        if not step2:
            raise ValueError("cpatches='basic' requires step 2")
        xc = xb
    else:
        raise ValueError(f"unknown cpatches [{cfg.cpatches}]")

    if cfg.couple_channels:
        # joint prior over channels: ONE covariance of dimension c*p per
        # group (reference params.py:173-179 coupleChannels semantics);
        # centering stays per-channel (it commutes with the concat)
        def _join(x):
            return jnp.transpose(x, (0, 2, 1, 3)).reshape(b, k, c * p)

        xc2 = _join(xc)
        xn2 = _join(xn)
        gc = 1                              # channel groups per site
        rank = min(cfg.rank, c * p)
    else:
        xc2 = xc.reshape(b * c, k, p)
        xn2 = xn.reshape(b * c, k, p)
        gc = c

    def _unjoin(xf):
        """(b*gc, k, p_eff) -> (B, c, K, p)."""
        if cfg.couple_channels:
            return jnp.transpose(xf.reshape(b, k, c, p), (0, 2, 1, 3))
        return xf.reshape(b, c, k, p)

    if cfg.eig_method in ("rational", "poly"):
        if cfg.eig_method == "poly":
            if cfg.poly_econ:
                from .polyspec import poly_filter_econ

                xf = poly_filter_econ(xc2, xn2, cfg)
            elif cfg.poly_fused and k < xc2.shape[-1]:
                from .polyspec import poly_filter_fused

                xf = poly_filter_fused(xc2, xn2, cfg)
            else:
                from .polyspec import poly_filter

                xf = poly_filter(xc2, xn2, cfg)
        else:
            from .spectral import rational_filter

            xf = rational_filter(xc2, xn2, cfg)
        # rank_var = full eigenvalue mass = trace(C) = ||Xc||^2 / K, exact
        trace = jnp.sum(xc2 * xc2, axis=(1, 2)) / k
        rank_var = trace.reshape(b, gc).mean(axis=1)
        out = _unjoin(xf) + cnoisy
        return _from_bcnp(out, pt, ps), rank_var

    lam, coeff, basis, domain = _spectral_filter(xc2, cfg, rank)

    rank_var = jnp.sum(lam.reshape(b, gc, -1), axis=2).mean(axis=1)

    if domain == "gram":
        # Shared-SVD identity: with Xc = sum_i sqrt(K mu_i) v_i u_i^T, the
        # covariance eigenvectors are u_i = Xc^T v_i / sqrt(K mu_i), so
        #   Xn U_r diag(c) U_r^T = Xn Xc^T V_r diag(c/(K mu)) V_r^T Xc.
        # The p-dim eigenvectors are never materialized — everything stays
        # in the smaller K-dim Gram domain (pure batched matmuls).
        mu_r = jnp.maximum(lam[:, :rank], 0.0)
        w = jnp.where(mu_r > 1e-8,
                      coeff / jnp.maximum(k * mu_r, 1e-10), 0.0)
        m = jnp.einsum("gkp,glp->gkl", xn2, xc2,
                       precision=_HI,
                     preferred_element_type=jnp.float32)   # Xn Xc^T
        t1 = jnp.einsum("gkl,glr->gkr", m, basis,
                        precision=_HI,
                     preferred_element_type=jnp.float32)
        t2 = jnp.einsum("gkr,glr->gkl", t1 * w[:, None, :], basis,
                        precision=_HI,
                     preferred_element_type=jnp.float32)
        xf = jnp.einsum("gkl,glp->gkp", t2, xc2,
                        precision=_HI,
                     preferred_element_type=jnp.float32)
    else:
        z = jnp.einsum("gkp,gpr->gkr", xn2, basis,
                       precision=_HI,
                     preferred_element_type=jnp.float32)
        xf = jnp.einsum("gkr,gpr->gkp", z * coeff[:, None, :], basis,
                        precision=_HI,
                     preferred_element_type=jnp.float32)

    out = _unjoin(xf) + cnoisy
    return _from_bcnp(out, pt, ps), rank_var


def _wiener_coeff(lam, cfg: StageConfig):
    """Eigenvalue shrinkage + Wiener gate (reference bayes_est.py:129-144)."""
    if cfg.mod_sel == "clipped":
        lam = lam - jnp.minimum(lam, cfg.sigmab2)
    elif cfg.mod_sel != "paul":
        raise ValueError(f"unknown eigen modifier [{cfg.mod_sel}]")
    gate = lam > (cfg.thresh * cfg.sigma2)
    return jnp.where(gate,
                     1.0 / (1.0 + cfg.sigma2 / jnp.where(gate, lam, 1.0)),
                     0.0)


def _spectral_filter(xc2, cfg: StageConfig, rank):
    """Eigen-spectrum + filter basis of the group covariance.

    Works in whichever domain is smaller (a redesign of the reference's
    always-p x p cuSOLVER eigh, SURVEY.md §2.2 N7):

    * ``cov`` domain (p <= K): eigh of C = X^T X / K (p x p);
    * ``gram`` domain (K < p): eigh of G = X X^T / K (K x K) — same nonzero
      spectrum (shared SVD), and the Wiener projection can be applied from
      the left with the K-dim eigenvectors, so the p-dim eigenvectors are
      never materialized.

    Returns (lam_full_desc, coeff (g, rank), basis, domain).
    """
    g, k, p = xc2.shape
    if k < p:
        gram = jnp.einsum("gkp,glp->gkl", xc2, xc2,
                          precision=_HI,
                     preferred_element_type=jnp.float32) / k
        mu, v = _eigh(gram, cfg)
        coeff = _wiener_coeff(mu[:, :rank], cfg)
        return mu, coeff, v[:, :, :rank], "gram"
    cov = jnp.einsum("gkp,gkq->gpq", xc2, xc2,
                     precision=_HI,
                     preferred_element_type=jnp.float32) / k
    lam, u = _eigh(cov, cfg)
    coeff = _wiener_coeff(lam[:, :rank], cfg)
    return lam, coeff, u[:, :, :rank], "cov"


def _eigh(mats, cfg: StageConfig):
    """Batched symmetric eigh, eigenvalues descending.

    ``cfg.eig_method``: "jacobi" = the framework's vectorized batched
    Jacobi (ops/eigh.py) — time scales with FLOPs, not with batch count;
    "xla" = jnp.linalg.eigh (reference semantics; on the GPU XLA calls
    cuSOLVER's batched syevd — the exact anchor for verification).
    """
    if cfg.eig_method == "xla":
        w, v = jnp.linalg.eigh(mats)
        return w[:, ::-1], v[:, :, ::-1]
    from .eigh import jacobi_eigh

    return jacobi_eigh(mats, sweeps=cfg.eig_sweeps)


def ave_denoise(pnoisy: jnp.ndarray) -> jnp.ndarray:
    """'ave' mode.

    The reference's deno dispatch computes the group mean but the caller
    discards the return value (deno/__init__.py:13-14 vs proc_nl.py:81), so
    the *effective* reference behavior — which ``denoise_mod`` relies on — is
    aggregation of the raw noisy patches.  We reproduce that behavior
    (identity) rather than the dead code path.
    """
    return pnoisy.astype(jnp.float32)
