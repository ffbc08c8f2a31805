"""Vectorized batched symmetric eigendecomposition (cyclic Jacobi).

Why this exists (SURVEY.md §7 hard part #2): the Bayes filter needs an eigh
of ~10^5 small (49..98-dim) covariance/Gram matrices per frame.  Where
``jnp.linalg.eigh`` serializes per-matrix sweeps, that is tens of seconds
per frame (on the GPU, cuSOLVER's batched eigh measured 1.7-2.1 us per
49-60-dim matrix — ROADMAP A4).  This implementation is a classic
one-sided-free cyclic Jacobi restructured for a SIMD model:

* **batch-trailing layout** ``(n, n, G)``: the batch axis G lives in the
  lane dimension, so every rotation update is an elementwise op over
  thousands of matrices simultaneously — wall time scales with total FLOPs,
  not with matrix count;
* **round-robin rotation schedule**: each round applies n/2 *disjoint*
  rotations at once (all independent), n-1 rounds visit every (p, q) pair
  exactly once per sweep; the schedule is a compile-time constant;
* rows/columns are updated with static-index gathers + a static inverse
  permutation (no scatters), which XLA lowers to cheap vector shuffles;
* quadratic convergence: 6-8 sweeps reach fp32 working accuracy for n<=128.

Semantics match ``jnp.linalg.eigh`` up to eigenvector sign and degenerate-
subspace rotation; eigenvalues are returned in DESCENDING order (the
convention of the Bayes filter, reference deno/bayes_est.py:123-124).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


def _round_robin_schedule(n: int) -> np.ndarray:
    """(n-1, 2, n/2) int32: disjoint (p, q) pairs per round, visiting every
    unordered pair exactly once (circle method; player 0 fixed)."""
    assert n % 2 == 0
    m = n // 2
    others = list(range(1, n))
    rounds = []
    for _ in range(n - 1):
        ps = [0] + others[:m - 1]
        qs = others[m - 1:][::-1]
        pairs = np.array([ps, qs])
        pairs = np.sort(pairs, axis=0)  # ensure p < q
        rounds.append(pairs)
        others = [others[-1]] + others[:-1]
    return np.stack(rounds).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("sweeps",))
def jacobi_eigh(mats: jnp.ndarray, sweeps: int = 8):
    """Batched symmetric eigh.

    Args:
      mats: (G, n, n) float32 symmetric matrices.
      sweeps: cyclic sweeps (each visits all n(n-1)/2 pairs once).

    Returns:
      evals: (G, n) float32, DESCENDING.
      evecs: (G, n, n) float32, evecs[g, :, i] is the eigenvector of
             evals[g, i].
    """
    g, n, n2 = mats.shape
    assert n == n2, mats.shape
    pad = n % 2  # schedule needs even n; pad with a decoupled zero row/col
    m = n + pad

    a = jnp.transpose(mats, (1, 2, 0))                     # (n, n, G)
    if pad:
        a = jnp.pad(a, ((0, 1), (0, 1), (0, 0)))
    # derive from `a` so the scan carry keeps the same device-variance
    # type under shard_map (zeros_like inherits `a`'s pvary)
    v = jnp.zeros_like(a) + jnp.eye(m, dtype=mats.dtype)[:, :, None]

    sched = _round_robin_schedule(m)                       # (m-1, 2, m/2)
    npairs = m // 2

    # static inverse permutation per round: rows stacked as [new_p; new_q]
    inv_perms = []
    for r in range(m - 1):
        perm = np.concatenate([sched[r, 0], sched[r, 1]])
        inv = np.empty(m, np.int32)
        inv[perm] = np.arange(m, dtype=np.int32)
        inv_perms.append(inv)
    inv_perms = np.stack(inv_perms)                        # (m-1, m)

    def one_round(carry, r):
        # r is a static python int: indices below are compile-time constants,
        # so the gathers/permutations lower to vector shuffles.
        a, v = carry
        p = sched[r, 0]
        q = sched[r, 1]
        inv = inv_perms[r]

        app = a[p, p, :]                                   # (npairs, G)
        aqq = a[q, q, :]
        apq = a[p, q, :]

        # rotation angle (LAPACK convention): t = sign(tau)/(|tau|+sqrt(1+tau^2))
        small = jnp.abs(apq) < 1e-30
        apq_safe = jnp.where(small, 1.0, apq)
        tau = (aqq - app) / (2.0 * apq_safe)
        t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
        t = jnp.where(tau == 0.0, 1.0, t)
        c = 1.0 / jnp.sqrt(1.0 + t * t)
        s = t * c
        c = jnp.where(small, 1.0, c)
        s = jnp.where(small, 0.0, s)

        cb = c[:, None, :]                                 # (npairs, 1, G)
        sb = s[:, None, :]

        # row rotation: A <- J^T A  (gather on axis 0, static indices)
        ap = a[p, :, :]                                    # (npairs, m, G)
        aq = a[q, :, :]
        new_p = cb * ap - sb * aq
        new_q = sb * ap + cb * aq
        a = jnp.concatenate([new_p, new_q], axis=0)[inv]   # (m, m, G)

        # column rotation: A <- A J  (gather on axis 1; no transposes)
        cc = c[None, :, :]                                 # (1, npairs, G)
        sc = s[None, :, :]
        ap = a[:, p, :]                                    # (m, npairs, G)
        aq = a[:, q, :]
        new_p = cc * ap - sc * aq
        new_q = sc * ap + cc * aq
        a = jnp.concatenate([new_p, new_q], axis=1)[:, inv]

        # eigenvector update: V <- V J (columns only)
        vp = v[:, p, :]
        vq = v[:, q, :]
        new_p = cc * vp - sc * vq
        new_q = sc * vp + cc * vq
        v = jnp.concatenate([new_p, new_q], axis=1)[:, inv]
        return (a, v), None

    def one_sweep(carry, _):
        for r in range(m - 1):  # static unroll: one sweep = m-1 rounds
            carry, _ = one_round(carry, r)
        return carry, None

    (a, v), _ = jax.lax.scan(one_sweep, (a, v), None, length=sweeps)

    diag = a[jnp.arange(m), jnp.arange(m), :]              # (m, G)
    evals = jnp.transpose(diag, (1, 0))                    # (G, m)
    evecs = jnp.transpose(v, (2, 0, 1))                    # (G, m, m)
    if pad:
        evals = evals[:, :n]
        evecs = evecs[:, :n, :n]

    order = jnp.argsort(-evals, axis=1)                    # descending
    evals = jnp.take_along_axis(evals, order, axis=1)
    evecs = jnp.take_along_axis(evecs, order[:, None, :], axis=2)
    return evals, evecs
