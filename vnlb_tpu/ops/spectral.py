"""Rational spectral Wiener filter — the fast path for the Bayes step.

Motivation (SURVEY.md §7 hard part #2): the exact filter needs an
eigendecomposition per patch group; both XLA's eigh and a batched Jacobi are
~100x off the 480p throughput target.  This module evaluates the SAME
spectral transfer function with matrix *rationals* — batched vectorized
Cholesky inverses (ops/linalg.py) + batched matmuls — no eigenvectors, no
per-matrix serialization.

Exact transfer function (reference deno/bayes_est.py:129-144, "clipped"):
    f(l) = [l > tau] * (l - sb2) / (l - sb2 + s2),  tau = thresh*s2 + sb2

Rational, numerically-stable approximation (all matrix functions of the
same SPD matrix commute, so the factors compose spectrally):

    wien(l) = (l - sb2) / (l + r2),     r2 = max(s2 - sb2, 0.1 s2)
              (== the clipped Wiener for l >> sb2; the gate kills l < tau)
    b(l)    = l / (l + tau_g),          tau_g = gate_scale * tau
    gate(l) = [1.25 b^2 / (b^2 + 1/4)]^m    (0.625^m at l = tau_g, -> 1
              above, -> (l/tau_g)^{2m} below; m = gate_power)

Conditioning: every inverse is either (A + tau_g I) / (A + r2 I) with
kappa <= lmax/r2, or (b^2 + 1/4 I) with kappa <= 5 — safe in fp32
(the naive A^2-based gate has kappa ~ (lmax/tau)^2 ~ 1e7+ and NaNs out).
Matrices are additionally normalized per group by s = tr(A)/n + s2 (the
transfer function depends only on ratios, so this is exact).

Domains (mirrors ops/bayes.py): the cov domain applies Xn * f~(C) directly;
the Gram domain uses the shared-SVD identity
    Xn U f(L) U^T = Xn Xc^T [f(G) / (K G)] Xc
where the 1/mu pole cancels analytically against the gate's mu^2 zero:
    gate(mu)/mu ~ A (A + tau I)^{-2} ...  (pure rationals, no pole).

Accuracy knobs: ``gate_power`` and ``gate_scale``; end-to-end deltas vs the
exact eigh path are pinned by tests/test_spectral.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .linalg import chol_inverse

_HI = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.einsum("gij,gjk->gik", a, b, precision=_HI,
                      preferred_element_type=jnp.float32)


def _sym(a):
    return 0.5 * (a + jnp.transpose(a, (0, 2, 1)))


def rational_filter(xc2: jnp.ndarray, xn2: jnp.ndarray, cfg) -> jnp.ndarray:
    """Spectrally-filtered patches, (G, K, p) in -> (G, K, p) out."""
    g, k, p = xc2.shape
    m = cfg.gate_power
    assert m in (1, 2), "gate_power must be 1 or 2"

    gram = k < p
    if gram:
        A = jnp.einsum("gkp,glp->gkl", xc2, xc2, precision=_HI,
                       preferred_element_type=jnp.float32) / k       # G (K,K)
    else:
        A = jnp.einsum("gkp,gkq->gpq", xc2, xc2, precision=_HI,
                       preferred_element_type=jnp.float32) / k       # C (p,p)
    n = A.shape[1]
    eye = jnp.eye(n, dtype=A.dtype)

    # per-group scale normalization (exact: the filter is scale-ratio based)
    scale = jnp.einsum("gii->g", A) / n + cfg.sigma2
    A = A / scale[:, None, None]
    s2 = cfg.sigma2 / scale
    sb2 = cfg.sigmab2 / scale
    tau_g = (cfg.thresh * cfg.sigma2 + cfg.sigmab2) * cfg.gate_scale / scale
    r2 = jnp.maximum(s2 - sb2, 0.1 * s2)

    def diag_add(mat, vec):
        return mat + vec[:, None, None] * eye

    # E = (A + tau_g I)^{-1};  b = A E  (symmetrized)
    E = chol_inverse(diag_add(A, tau_g))
    b = _sym(_mm(A, E))
    S = _mm(b, b)
    Fi = chol_inverse(S + 0.25 * eye)                     # kappa <= 5
    gate1 = 1.25 * _sym(_mm(S, Fi))                       # (G, n, n)

    # Wiener: W = (A - sb2 I)(A + r2 I)^{-1}
    Wi = chol_inverse(diag_add(A, r2))
    wien = _sym(_mm(diag_add(A, -sb2), Wi))

    if gram:
        # X_hat = (Xn Xc^T) [gate^m(G) wien(G) / (K G)] Xc
        # gate/G = 1.25 (S + 1/4 I)^{-1} A E^2   (pole cancels analytically)
        # (everything is in normalized units; the K and scale factors cancel
        #  except the explicit 1/K of the Gram-domain identity * 1/scale of
        #  the normalized G in the denominator)
        Mx = jnp.einsum("gkp,glp->gkl", xn2, xc2, precision=_HI,
                        preferred_element_type=jnp.float32)
        AE = _mm(A, E)
        gate_over_g = 1.25 * _mm(Fi, _mm(AE, E))          # b^2/(b^2+1/4)/G
        H = gate_over_g
        if m == 2:
            H = _mm(gate1, H)
        HW = _mm(H, wien)
        Z = _mm(HW, xc2)
        return jnp.einsum("gkl,glp->gkp", Mx / (k * scale)[:, None, None], Z,
                          precision=_HI, preferred_element_type=jnp.float32)

    # cov domain: X_hat = Xn gate^m(C) wien(C)
    F = _mm(gate1, wien)
    if m == 2:
        F = _mm(gate1, F)
    return jnp.einsum("gkp,gpq->gkq", xn2, F, precision=_HI,
                      preferred_element_type=jnp.float32)
