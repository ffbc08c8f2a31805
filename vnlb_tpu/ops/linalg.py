"""Vectorized batched dense linear algebra (batch-in-lanes layout).

XLA's LAPACK-style ops (cholesky/eigh/solve) can serialize per matrix,
which is unusable at this framework's ~10^5 matrices/frame.  These routines
keep the batch axis G in the trailing (lane) dimension so every
factorization step is an elementwise op over all matrices at once;
the sequential depth is only n (the matrix size, <= ~128).

The row/column recurrences run under ``lax.fori_loop`` with full-width
masked updates (constant shapes per step): ~2x the triangular FLOPs, but a
tiny compiled graph (n-step unrolled variable-shape loops compile
slowly).

Used by the rational spectral filter (ops/spectral.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cholesky_vec(a: jnp.ndarray) -> jnp.ndarray:
    """Lower Cholesky of SPD mats in batch-trailing layout (n, n, G)."""
    n = a.shape[0]
    idx = jnp.arange(n)

    def body(j, L):
        # s[i] = sum_{k<j} L[i,k] L[j,k]   (full-width, masked k<j)
        mask = (idx < j).astype(a.dtype)                  # (n,)
        lrow_j = jax.lax.dynamic_slice_in_dim(L, j, 1, axis=0)[0]  # (n, G)
        s = jnp.einsum("nkg,kg->ng", L, lrow_j * mask[:, None])
        col = jax.lax.dynamic_slice_in_dim(a, j, 1, axis=1)[:, 0] - s
        dj = jnp.sqrt(jnp.maximum(jnp.take(col, j, axis=0), 1e-20))
        col = col / dj
        col = col * (idx >= j).astype(a.dtype)[:, None]
        return jax.lax.dynamic_update_slice_in_dim(
            L, col[:, None, :], j, axis=1)

    L0 = jnp.zeros_like(a)
    return jax.lax.fori_loop(0, n, body, L0)


def lower_inverse_vec(L: jnp.ndarray) -> jnp.ndarray:
    """Inverse of a lower-triangular (n, n, G) by forward substitution."""
    n = L.shape[0]
    idx = jnp.arange(n)

    def body(i, X):
        mask = (idx < i).astype(L.dtype)                  # (n,)
        lrow = jax.lax.dynamic_slice_in_dim(L, i, 1, axis=0)[0]   # (n, G)
        s = jnp.einsum("kg,kng->ng", lrow * mask[:, None], X)
        e = (idx == i).astype(L.dtype)[:, None]           # (n, 1)
        dii = jnp.take(jnp.take(L, i, axis=0), i, axis=0)
        row = (e - s) / dii
        return jax.lax.dynamic_update_slice_in_dim(
            X, row[None, :, :], i, axis=0)

    X0 = jnp.zeros_like(L)
    return jax.lax.fori_loop(0, n, body, X0)


@jax.jit
def chol_inverse(mats: jnp.ndarray) -> jnp.ndarray:
    """Inverse of SPD matrices, (G, n, n) -> (G, n, n).

    A^{-1} = L^{-T} L^{-1} with the factor and substitution fully
    vectorized over the batch; the closing Gram product is one batched
    matmul.
    """
    g, n, n2 = mats.shape
    assert n == n2
    a = jnp.transpose(mats, (1, 2, 0))                    # (n, n, G)
    L = cholesky_vec(a)
    Linv = lower_inverse_vec(L)
    inv = jnp.einsum("kig,kjg->ijg", Linv, Linv)          # L^{-T} L^{-1}
    return jnp.transpose(inv, (2, 0, 1))
