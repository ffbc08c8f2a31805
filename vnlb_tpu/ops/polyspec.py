"""Polynomial spectral Wiener filter — matmul-only fast path for the Bayes step.

Why (round-2 redesign of ops/spectral.py): the rational fast path evaluates
its spectral transfer function with batched Cholesky inverses whose
``fori_loop`` recurrences are *latency*-bound (~300 dependent
micro-steps per batch — the dominant pipeline phase in an early profile),
and its softened gate runs the basic pass ~0.5 dB soft.  This module
evaluates the exact transfer function (reference
lib/vnlb/deno/bayes_est.py:129-144, "clipped" mode)

    f(lam) = [lam > tau] * (lam - sb2) / (lam - sb2 + s2),
    tau    = thresh * s2 + sb2

entirely with batched matrix products — which run on the matrix units and
parallelize freely over the ~10^5 patch groups per frame:

* the hard gate ``[lam > tau]`` is a **matrix sign** iteration on
  (C - tau I)/c.  The schedule composes two polynomial families (cf. the
  tuned quintic orthogonalization schedules used by Muon-style optimizers):
  a few *aggressive* quintic steps with slope ~3.44 at the origin (fast
  transition sharpening; values stay in ~[-1.1, 1.1]), then cubic
  Newton-Schulz *polish* steps S <- (3S - S^3)/2 that contract everything
  onto +-1 (so the gate is ~exactly 0/1, no Muon-style residual ripple).
  ``ns_iters`` parameterizes the CUBIC-EQUIVALENT sharpness (width ~
  c * 1.5^-ns_iters around tau); the schedule matches that width with
  ~40% fewer matmuls than pure cubic iteration.
* the smooth Wiener factor is a per-group **Chebyshev expansion** in
  C/lub (degree ``poly_deg``); the target is evaluated at Chebyshev nodes
  and projected with one constant DCT matrix, so per-group spectral-scale
  variation costs one tiny (G, nodes) @ (nodes, deg+1) matmul.
* ``lub`` (spectral upper bound) = min(trace, max row sum) — both valid
  bounds for SPD matrices; no power iteration, no failure mode.

Always the covariance (p x p) domain: the Gram-domain shared-SVD identity
needs f(lam)/lam, whose 1/lam re-amplifies the fit error by lam_max/tau
(measured 100x+ patch error on strong-signal groups) — the cov domain has
no pole.  ``cfg.rank`` is NOT applied (a spectral function has no order
statistic); eigenvalues ranked below ``rank`` are almost always below
``tau`` and killed by the gate — the same approximation the rational path
makes (docs/COMPARE.md).

Three evaluators, in order of arrival (the config dispatches in bayes.py):

* ``poly_filter``      — two-factor: matrix-sign gate x Chebyshev Wiener
  (the description above); kept as the verification reference.
* ``poly_filter_fused``— ONE combined gate x Wiener Chebyshev series
  through the left-side T_j recurrence (K < p only).
* ``poly_filter_econ`` — PRODUCTION: the same combined series evaluated
  with the T_s-substitution + Clenshaw scheme (~half the matmul ops of
  small batched products, whose op COUNT sets the filter phase's time).

Accuracy is pinned against the exact-eigh path by tests/test_polyspec.py.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def _dct_matrix(deg: int, nodes: int):
    """Constant (nodes, deg+1) projection: node values -> Chebyshev coeffs."""
    jj = np.arange(deg + 1)
    m = np.cos(np.pi * jj[:, None] * (np.arange(nodes) + 0.5)[None, :]
               / nodes) * (2.0 / nodes)
    m[0] *= 0.5
    return m.T.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _cheb_nodes(nodes: int):
    return np.cos(np.pi * (np.arange(nodes) + 0.5) / nodes).astype(np.float32)


# Aggressive quintic sign step: slope 3.4445 at 0, |out| <= ~1.10 on
# [-1.1, 1.1] (the tuned Muon/orthogonalization coefficients).  Composed
# slope after n_a aggressive + n_p cubic-polish steps: 3.4445^n_a * 1.5^n_p.
_AGGR = (3.4445, -4.7750, 2.0315)


def _sign_schedule(ns_iters: int, n_polish: int = 3):
    """(n_aggressive, n_polish) matching the cubic-1.5^ns_iters width."""
    import math
    target = 1.5 ** ns_iters / 1.5 ** n_polish
    n_aggr = max(1, math.ceil(math.log(max(target, 1.001))
                              / math.log(_AGGR[0])))
    return n_aggr, n_polish


def poly_filter(xc2: jnp.ndarray, xn2: jnp.ndarray, cfg) -> jnp.ndarray:
    """Spectrally-filtered patches, (G, K, p) in -> (G, K, p) out.

    xc2: centered covariance-source patches; xn2: centered noisy patches.
    """
    g, k, p = xc2.shape
    s2, sb2 = cfg.sigma2, cfg.sigmab2
    tau = cfg.thresh * s2 + sb2
    wdeg = cfg.poly_deg
    nodes = max(64, 2 * (wdeg + 1))

    def mm(a, b):
        return jnp.einsum("gij,gjk->gik", a, b,
                          preferred_element_type=jnp.float32)

    a_cov = jnp.einsum("gkp,gkq->gpq", xc2, xc2, precision=_HI,
                       preferred_element_type=jnp.float32) / k
    eye = jnp.eye(p, dtype=a_cov.dtype)

    tr = jnp.einsum("gii->g", a_cov)
    rowsum = jnp.max(jnp.sum(jnp.abs(a_cov), axis=2), axis=1)
    lub = jnp.maximum(jnp.minimum(tr, rowsum), 1.5 * tau) * 1.02

    # matrices are STORED in bf16 between matmuls (default-precision
    # matmuls round their inputs anyway — TF32 on the GPU; fp32 storage
    # would double the memory traffic of ~20 batched (p,p) intermediates
    # per group).  Accumulation and elementwise combines stay fp32.  The sign
    # iteration has attracting fixed points at +-1, so bf16 rounding does
    # not accumulate; quality is pinned by tests/test_polyspec.py.
    sdty = jnp.bfloat16 if cfg.poly_bf16 else jnp.float32

    def st(x):
        return x.astype(sdty)

    # ---- matrix sign gate: W ~ H(lam - tau) ------------------------------
    # aggressive quintic steps sharpen the transition ~2.8x faster per
    # matmul than cubic NS; the cubic polish contracts the Muon-style
    # ripple (values in ~[0.7, 1.1] after aggressive steps) onto +-1.
    n_aggr, n_polish = _sign_schedule(cfg.ns_iters)
    sc = jnp.maximum(lub - tau, tau)
    s_mat = st((a_cov - tau * eye) / sc[:, None, None])
    a, b_, c_ = _AGGR
    for _ in range(n_aggr):
        s2m = st(mm(s_mat, s_mat))
        s3m = mm(s2m, s_mat)
        s5m = mm(s2m, st(s3m))
        s_mat = st(a * s_mat.astype(jnp.float32) + b_ * s3m + c_ * s5m)
    for _ in range(n_polish):
        s_mat = st(1.5 * s_mat.astype(jnp.float32)
                   - 0.5 * mm(s_mat, st(mm(s_mat, s_mat))))
    w_gate = 0.5 * (s_mat.astype(jnp.float32) + eye)

    # ---- smooth Wiener factor via per-group Chebyshev --------------------
    xs = jnp.asarray(_cheb_nodes(nodes))
    dct = jnp.asarray(_dct_matrix(wdeg, nodes))
    lam_i = (xs[None, :] + 1.0) * 0.5 * lub[:, None]          # (G, nodes)
    lam_c = jnp.maximum(lam_i, 0.9 * tau)                     # gated region
    wv = (lam_c - sb2) / (lam_c - sb2 + s2)
    coef = wv @ dct                                           # (G, wdeg+1)

    ah = st(2.0 * a_cov / lub[:, None, None] - eye)

    if k < p:
        # LEFT-side evaluation: the gate and the Chebyshev factor are
        # polynomials of the same matrix (they commute), so
        # y = xn2 W Q = ((xn2 W) applied through the T_j recurrence) —
        # every recurrence step is a (K,p)@(p,p) matmul instead of
        # (p,p)@(p,p): cheaper whenever K < p (stage 1: K=60, p=98).
        # The T_j recurrence is evaluated in fp32 with bf16-stored operands
        # (|T_j| <= 1 on the spectrum, so rounding stays ~2^-8 per step).
        y0 = jnp.einsum("gkp,gpq->gkq", xn2, w_gate,
                        preferred_element_type=jnp.float32)
        z_prev = y0
        z_cur = jnp.einsum("gkp,gpq->gkq", st(y0), ah,
                           preferred_element_type=jnp.float32)
        acc = coef[:, 0, None, None] * z_prev + coef[:, 1, None, None] * z_cur
        for j in range(2, wdeg + 1):
            z_nxt = 2.0 * jnp.einsum("gkp,gpq->gkq", st(z_cur), ah,
                                     preferred_element_type=jnp.float32) \
                - z_prev
            acc = acc + coef[:, j, None, None] * z_nxt
            z_prev, z_cur = z_cur, z_nxt
        return acc

    t_prev = jnp.broadcast_to(eye, a_cov.shape)
    t_cur = ah.astype(jnp.float32)
    q = coef[:, 0, None, None] * t_prev + coef[:, 1, None, None] * t_cur
    for j in range(2, wdeg + 1):
        t_nxt = 2.0 * mm(ah, st(t_cur)) - t_prev
        q = q + coef[:, j, None, None] * t_nxt
        t_prev, t_cur = t_cur, t_nxt

    f_mat = mm(st(w_gate), st(q))
    return jnp.einsum("gkp,gpq->gkq", xn2, st(f_mat),
                      preferred_element_type=jnp.float32)


def poly_filter_fused(xc2: jnp.ndarray, xn2: jnp.ndarray, cfg) -> jnp.ndarray:
    """Single-polynomial spectral filter for the K < p regime.

    The full transfer function gate(lam)*wiener(lam) is fit per group by ONE
    Chebyshev series of degree ``poly_deg_fused`` and applied entirely
    through the left-side T_j recurrence on xn2 — every matmul is
    (K,p)@(p,p); there are ZERO (p,p)@(p,p) products (no matrix sign
    iteration, no Q composition).  ~1.5x fewer matmul-units than the
    two-factor path at stage-1 shapes.

    Sharpness: Chebyshev nodes cluster quadratically at the interval ends,
    and tau sits near the 0-end when lub >> tau, so a degree-D series
    resolves features of width ~(pi/D)*sqrt(tau*lub) there.  The hard gate
    is pre-smoothed to exactly that width (logistic, ``fuse_beta`` x the
    node spacing) to suppress Gibbs ripple; measured scalar-domain error
    vs the exact clipped-Wiener transfer: <=1.3% outside the transition
    band for lub up to 500*tau at D=28 (negative ripple <=5%).  The
    transition width is comparable to the ns_iters=10 sign gate
    (lub/58 vs ~lub/44 at lub=100tau).
    """
    g, k, p = xc2.shape
    s2, sb2 = cfg.sigma2, cfg.sigmab2
    tau = cfg.thresh * s2 + sb2
    deg = cfg.poly_deg_fused
    nodes = max(64, 2 * (deg + 1))
    sdty = jnp.bfloat16 if cfg.poly_bf16 else jnp.float32

    def st(x):
        return x.astype(sdty)

    # 1-pass bf16-multiply covariance (DEFAULT): the fused series only
    # needs the spectrum to ~bf16 accuracy (the gate is pre-smoothed to
    # the node spacing anyway).  Measured in round 2: two-pass PSNR
    # bit-identical on the pin clip vs HIGH's 3 passes, which were ~2 of
    # the chain's ~13 matmul-units.
    a_cov = jnp.einsum("gkp,gkq->gpq", xc2, xc2,
                       preferred_element_type=jnp.float32) / k
    eye = jnp.eye(p, dtype=a_cov.dtype)

    tr = jnp.einsum("gii->g", a_cov)
    rowsum = jnp.max(jnp.sum(jnp.abs(a_cov), axis=2), axis=1)
    lub = jnp.maximum(jnp.minimum(tr, rowsum), 1.5 * tau) * 1.02

    xs = jnp.asarray(_cheb_nodes(nodes))
    dct = jnp.asarray(_dct_matrix(deg, nodes))
    lam_i = (xs[None, :] + 1.0) * 0.5 * lub[:, None]          # (G, nodes)
    # logistic gate smoothed to the local Chebyshev resolution at tau
    wg = 1.2 * (np.pi / deg) * jnp.sqrt(tau * lub)            # (G,)
    gate = jax.nn.sigmoid((lam_i - tau) / (wg[:, None] / 4.4))
    lam_s = jnp.maximum(lam_i - sb2, 0.0)
    fv = gate * lam_s / (lam_s + s2)
    coef = fv @ dct                                           # (G, deg+1)

    ah = st(2.0 * a_cov / lub[:, None, None] - eye)

    z_prev = xn2
    z_cur = jnp.einsum("gkp,gpq->gkq", st(xn2), ah,
                       preferred_element_type=jnp.float32)
    acc = coef[:, 0, None, None] * z_prev + coef[:, 1, None, None] * z_cur
    for j in range(2, deg + 1):
        z_nxt = 2.0 * jnp.einsum("gkp,gpq->gkq", st(z_cur), ah,
                                 preferred_element_type=jnp.float32) - z_prev
        acc = acc + coef[:, j, None, None] * z_nxt
        z_prev, z_cur = z_cur, z_nxt
    return acc


# ---------------------------------------------------------------------------
# Economized evaluation: T_s substitution + Clenshaw.
#
# The matmul-op COUNT sets the filter phase's time (per-op cost of these
# small batched products is ~flat across (K,p)@(p,p) and (p,p)@(p,p)).  A degree-(m*s-1) polynomial is evaluated with
# s-1 (+1) matmuls for the inner residues, 2-3 for B = T_s(Ah) via the
# power identities, and m Clenshaw steps in B — ~8-10 ops instead of the
# D=16 ops of the plain T_j recurrence (left regime), ~9-10 instead of
# ~25 (matrix regime).
#
# Basis: phi_{i,r}(x) = T_i(T_s(x)) * T_r(x), i<m, r<s — leading degrees
# i*s+r are all distinct, so the m*s functions span exactly the degree
# <= m*s-1 polynomials: the least-squares projection at the shared
# Chebyshev nodes is THE SAME polynomial as the plain Chebyshev series of
# that degree (quality pins unchanged).  The projection matrix
# pinv(Phi)^T is a fixed constant (group-independent); per-group
# coefficients are one (G, nodes) @ (nodes, m*s) matmul, exactly like the
# DCT projection of the plain path.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ps_split(deg: int):
    """(m, s) with m*s >= deg+1, s ~ sqrt(deg)."""
    import math
    s = min(4, max(2, int(round(math.sqrt(deg + 1)))))
    m = -(-(deg + 1) // s)
    return m, s


@functools.lru_cache(maxsize=None)
def _gram_maps(m: int, s: int, nodes: int):
    """Static maps for the GRAM-domain econ route (K < p regime).

    The route needs, per group, the econ-basis coefficients of
    g_hat(x) := (f_hat(x) - f_hat(-1)) / (x + 1), where f_hat is the
    degree-D (D = m*s) Chebyshev least-squares fit of the transfer values
    at the shared nodes.  Because f_hat - f_hat(-1) has an EXACT root at
    x = -1, the division is exact polynomial division of the FITTED
    series — the transfer error stays f_hat's fit error, with none of the
    lam_max/tau amplification that fitting f/lam directly would suffer
    (the pole objection documented in the module docstring applies to
    fitting the target f/lam, not to dividing the fitted polynomial).

    Everything from node values to g_hat's econ coefficients is one
    composed constant matrix.  Returns (gmap (nodes, m*s), v0 (nodes,)):
      gamma_flat = fvals @ gmap ;  f0 = fvals @ v0.
    """
    d_deg = m * s                                   # f_hat degree
    proj = _dct_matrix(d_deg, nodes).T              # (D+1, nodes): c = P f
    w0 = np.array([(-1.0) ** j for j in range(d_deg + 1)])
    e0 = np.zeros((d_deg + 1,))
    e0[0] = 1.0
    sub = np.eye(d_deg + 1) - np.outer(e0, w0)      # a = c - f0 e0
    # L: cheb coeffs of (x+1) * T_j, j < D  ->  columns of (D+1, D)
    lmat = np.zeros((d_deg + 1, d_deg))
    for j in range(d_deg):
        lmat[j, j] += 1.0                           # + T_j
        if j == 0:
            lmat[1, 0] += 1.0                       # x T_0 = T_1
        else:
            lmat[j + 1, j] += 0.5                   # x T_j = (T_{j+1}
            lmat[j - 1, j] += 0.5                   #        + T_{j-1})/2
    div = np.linalg.pinv(lmat)                      # (D, D+1): b = div a
    xs = np.cos(np.pi * (np.arange(nodes) + 0.5) / nodes)
    t2 = np.stack([np.cos(j * np.arccos(xs)) for j in range(d_deg)],
                  axis=0)                           # (D, nodes): g at nodes
    pphi = _ps_basis_pinv(m, s, nodes)              # (nodes, m*s)
    gmap = (pphi.T @ t2.T @ div @ sub @ proj).T     # (nodes, m*s)
    v0 = (w0 @ proj)                                # (nodes,)
    return gmap.astype(np.float32), v0.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ps_basis_pinv(m: int, s: int, nodes: int):
    """(nodes, m*s) pseudo-inverse-transpose: node values -> gamma[i,r]."""
    xs = np.cos(np.pi * (np.arange(nodes) + 0.5) / nodes)

    def cheb_t(j, x):
        return np.cos(j * np.arccos(np.clip(x, -1.0, 1.0)))

    ts = cheb_t(s, xs)
    phi = np.stack([cheb_t(i, ts) * cheb_t(r, xs)
                    for i in range(m) for r in range(s)], axis=1)
    return np.linalg.pinv(phi).T.astype(np.float32)      # (nodes, m*s)


@functools.lru_cache(maxsize=None)
def _blockdiag_mask2(q: int):
    """(2q, 2q) 0/1 numpy mask keeping the two diagonal q-blocks."""
    return _blockdiag_maskn(q, 2)


@functools.lru_cache(maxsize=None)
def _blockdiag_maskn(q: int, n: int):
    """(nq, nq) 0/1 numpy mask keeping the n diagonal q-blocks."""
    m = np.zeros((n * q, n * q), np.float32)
    for i in range(n):
        m[i * q:(i + 1) * q, i * q:(i + 1) * q] = 1.0
    return m


def poly_filter_econ(xc2: jnp.ndarray, xn2: jnp.ndarray, cfg) -> jnp.ndarray:
    """Economized single-polynomial spectral filter (both K<p and K>=p)."""
    g, k, p = xc2.shape
    s2, sb2 = cfg.sigma2, cfg.sigmab2
    tau = cfg.thresh * s2 + sb2
    m, s = _ps_split(cfg.poly_deg_fused)
    deg = m * s - 1
    nodes = max(64, 2 * (deg + 1))
    sdty = jnp.bfloat16 if cfg.poly_bf16 else jnp.float32

    def st(x):
        return x.astype(sdty)

    def lmm(a, b):                                       # (G,K,p) @ (G,p,p)
        return jnp.einsum("gkp,gpq->gkq", st(a), st(b),
                          preferred_element_type=jnp.float32)

    def mmm(a, b):                                       # (G,p,p) @ (G,p,p)
        return jnp.einsum("gij,gjk->gik", st(a), st(b),
                          preferred_element_type=jnp.float32)

    def transfer_vals(lub):
        """Smoothed gate x Wiener target at the per-group scaled nodes."""
        xs = jnp.asarray(_cheb_nodes(nodes))
        lam_i = (xs[None, :] + 1.0) * 0.5 * lub[:, None]
        wg = 1.2 * (np.pi / deg) * jnp.sqrt(tau * lub)
        gate = jax.nn.sigmoid((lam_i - tau) / (wg[:, None] / 4.4))
        lam_s = jnp.maximum(lam_i - sb2, 0.0)
        return gate * lam_s / (lam_s + s2)

    if k < p and cfg.poly_gram:
        # GRAM-domain route: the whole chain runs on K x K matrices (the
        # group Gram) instead of p x p, via  Xn f(C) = f0 Xn +
        # (Xn Xc^T) g(Xc Xc^T / K) Xc / K  with g the exact polynomial
        # division (f - f0)/lam of the fitted series (see _gram_maps).
        # The p x p covariance is never formed (tr C = tr Gram, and any
        # SPD upper bound works for lub).  Stage 1 (K=60, p=98): ~7
        # effective matmul ops per group vs ~11 98-dim ops on the
        # left-regime route, because 2K <= 128 lets the Clenshaw chain
        # pack two groups per block-diagonal matrix.
        if cfg.poly_pack2 and 2 * k <= 128 and g % 2 == 0 and g >= 2:
            return _poly_econ_gram_packed(xc2, xn2, m, s, nodes, tau, cfg,
                                          transfer_vals)
        gram = jnp.einsum("gkp,glp->gkl", xc2, xc2,
                          preferred_element_type=jnp.float32) / k
        tr = jnp.einsum("gii->g", gram)
        rowsum = jnp.max(jnp.sum(jnp.abs(gram), axis=2), axis=1)
        lub = jnp.maximum(jnp.minimum(tr, rowsum), 1.5 * tau) * 1.02
        fv = transfer_vals(lub)
        gmap, v0 = _gram_maps(m, s, nodes)
        gam_g = (fv @ jnp.asarray(gmap)).reshape(g, m, s)
        f0 = fv @ jnp.asarray(v0)                              # (G,)
        return _poly_econ_gram(xc2, xn2, gram, lub, gam_g, f0, m, s, cfg)

    if (k >= p and cfg.poly_pack2 and 2 * p <= 128 and g % 2 == 0
            and g >= 2):
        # matrix regime with 2-groups-per-matrix block-diagonal packing:
        # halves the matmul ops when p <= 64 (step-0 iphone preset p=49)
        return _poly_econ_packed(xc2, xn2, m, s, nodes, tau, cfg,
                                 transfer_vals)

    # 1-pass bf16-multiply covariance — see poly_filter_fused's note
    a_cov = jnp.einsum("gkp,gkq->gpq", xc2, xc2,
                       preferred_element_type=jnp.float32) / k
    eye = jnp.eye(p, dtype=a_cov.dtype)

    tr = jnp.einsum("gii->g", a_cov)
    rowsum = jnp.max(jnp.sum(jnp.abs(a_cov), axis=2), axis=1)
    lub = jnp.maximum(jnp.minimum(tr, rowsum), 1.5 * tau) * 1.02
    fv = transfer_vals(lub)
    gam = (fv @ jnp.asarray(_ps_basis_pinv(m, s, nodes))).reshape(g, m, s)

    ah = 2.0 * a_cov / lub[:, None, None] - eye

    # T_r(Ah) as needed, and B = T_s(Ah) from the even power identities
    a2 = mmm(ah, ah)
    if s == 4:
        a4 = mmm(a2, a2)
        b_mat = 8.0 * a4 - 8.0 * a2 + eye                # T_4
        t3 = mmm(4.0 * a2 - 3.0 * eye, ah)               # T_3 = (4x^2-3)x
        t_mats = [None, ah, 2.0 * a2 - eye, t3]          # T_0..T_3
    elif s == 3:
        b_mat = mmm(4.0 * a2 - 3.0 * eye, ah)            # T_3
        t_mats = [None, ah, 2.0 * a2 - eye]
    elif s == 2:
        b_mat = 2.0 * a2 - eye
        t_mats = [None, ah]
    else:
        raise NotImplementedError(f"ps split s={s}")

    if k < p:
        # left regime: z_r = xn2 T_r(Ah) via the T recurrence, then
        # row-space Clenshaw in B
        zs = [xn2, lmm(xn2, ah)]
        for _ in range(2, s):
            zs.append(2.0 * lmm(zs[-1], ah) - zs[-2])
        w_rows = [sum(gam[:, i, r, None, None] * zs[r] for r in range(s))
                  for i in range(m)]
        b_hi = jnp.zeros_like(xn2)
        b_lo = jnp.zeros_like(xn2)
        for i in range(m - 1, 0, -1):
            b_new = w_rows[i] + 2.0 * lmm(b_hi, b_mat) - b_lo
            b_lo, b_hi = b_hi, b_new
        return w_rows[0] + lmm(b_hi, b_mat) - b_lo

    # matrix regime: V_i = sum_r gamma T_r(Ah), matrix Clenshaw in B,
    # then one application to xn2
    def t_of(r):
        return jnp.broadcast_to(eye, a_cov.shape) if r == 0 else t_mats[r]

    v_mats = [sum(gam[:, i, r, None, None] * t_of(r) for r in range(s))
              for i in range(m)]
    b_hi = jnp.zeros_like(a_cov)
    b_lo = jnp.zeros_like(a_cov)
    for i in range(m - 1, 0, -1):
        b_new = v_mats[i] + 2.0 * mmm(b_hi, b_mat) - b_lo
        b_lo, b_hi = b_hi, b_new
    f_mat = v_mats[0] + mmm(b_hi, b_mat) - b_lo
    return lmm(xn2, f_mat)


def _chain_mats(ahx, coef, m, s, mmm, eye):
    """Shared T_s-substitution + Clenshaw matrix chain.

    ahx: (G', q, q) normalized operand; coef(i, r) -> broadcastable
    coefficient array for term T_i(T_s) * T_r.  Returns f(ahx) (G', q, q).
    """
    a2 = mmm(ahx, ahx)
    if s == 4:
        a4 = mmm(a2, a2)
        b_mat = 8.0 * a4 - 8.0 * a2 + eye
        t3 = mmm(4.0 * a2 - 3.0 * eye, ahx)
        t_mats = [None, ahx, 2.0 * a2 - eye, t3]
    elif s == 3:
        b_mat = mmm(4.0 * a2 - 3.0 * eye, ahx)
        t_mats = [None, ahx, 2.0 * a2 - eye]
    elif s == 2:
        b_mat = 2.0 * a2 - eye
        t_mats = [None, ahx]
    else:
        raise NotImplementedError(f"ps split s={s}")

    def t_of(r):
        return jnp.broadcast_to(eye, ahx.shape) if r == 0 else t_mats[r]

    v_mats = [sum(coef(i, r) * t_of(r) for r in range(s)) for i in range(m)]
    b_hi = jnp.zeros_like(ahx)
    b_lo = jnp.zeros_like(ahx)
    for i in range(m - 1, 0, -1):
        b_new = v_mats[i] + 2.0 * mmm(b_hi, b_mat) - b_lo
        b_lo, b_hi = b_hi, b_new
    return v_mats[0] + mmm(b_hi, b_mat) - b_lo


def _poly_econ_gram(xc2, xn2, gram, lub, gam, f0, m, s, cfg):
    """GRAM-domain econ evaluation (K < p), UNPACKED: Xn f(C) = f0 Xn +
    (Xn Xc^T) g(Gram) Xc / K, chain on K x K matrices.
    gam: (G, m, s) econ coefficients of g; f0: (G,)."""
    g, k, p = xc2.shape
    sdty = jnp.bfloat16 if cfg.poly_bf16 else jnp.float32

    def st(x):
        return x.astype(sdty)

    def mmm(a, b):
        return jnp.einsum("gij,gjk->gik", st(a), st(b),
                          preferred_element_type=jnp.float32)

    eye_k = jnp.eye(k, dtype=jnp.float32)
    gh = 2.0 * gram / lub[:, None, None] - eye_k
    mh = jnp.einsum("gkp,glp->gkl", xn2, xc2,
                    preferred_element_type=jnp.float32)       # Xn Xc^T
    g_mat = _chain_mats(gh, lambda i, r: gam[:, i, r, None, None],
                        m, s, mmm, eye_k)
    t_m = mmm(mh, g_mat)
    y = jnp.einsum("gij,gjp->gip", st(t_m), st(xc2),
                   preferred_element_type=jnp.float32)
    # chain rule of the division variable: f - f0 = (x+1) g_hat(x) with
    # x + 1 = 2 lam / lub, so g(lam) = (2/lub) g_hat(x); plus the /K of
    # Xn C q(C) = Xn Xc^T q(Gram) Xc / K
    return f0[:, None, None] * xn2 + y * (2.0 / (k * lub))[:, None, None]


def _poly_econ_gram_packed(xc2, xn2, m, s, nodes, tau, cfg, transfer_vals,
                           n_pack: int = 2):
    """GRAM-domain econ evaluation with n-groups-per-tile packing, built by
    MASKED STACKED PRODUCTS: the packed block-diagonal Gram / cross matrices
    are computed directly as ONE (nK, p) @ (p, nK) matmul per n-tuple with a
    constant 0/1 block mask fused into the epilogue — no separate per-group
    matmuls and no block-diagonal assembly (the ``zeros().at[].set`` form
    lowers to scatters; a pad+concat form still costs two dense
    copies).  The masked diagonal blocks contract
    over the same K terms as the unpacked products, and every chain step
    preserves exact block-diagonality (off-diagonal zeros stay zero through
    products and the diagonal eye), so results match the unpacked route to
    fp rounding of the lub scaling order.

    ``n_pack``: wider packs cut the matmul op count further at n x the
    work per op (GPU effect not measured)."""
    g, k, p = xc2.shape
    n = n_pack
    g2, k2 = g // n, n * k
    sdty = jnp.bfloat16 if cfg.poly_bf16 else jnp.float32

    def st(x):
        return x.astype(sdty)

    def mmm(a, b):
        return jnp.einsum("gij,gjk->gik", st(a), st(b),
                          preferred_element_type=jnp.float32)

    mask = jnp.asarray(_blockdiag_maskn(k, n))
    xc_st = xc2.reshape(g2, k2, p)
    xn_st = xn2.reshape(g2, k2, p)
    gram_p = jnp.einsum("gip,gjp->gij", xc_st, xc_st,
                        preferred_element_type=jnp.float32) * (mask / k)
    # per-block spectral bound: masked rows only contain their own block
    diag = jnp.einsum("gii->gi", gram_p)                      # (G2, nK)
    tr2 = jnp.sum(diag.reshape(g2, n, k), axis=2)             # (G2, n)
    rs2 = jnp.max(jnp.sum(jnp.abs(gram_p), axis=2).reshape(g2, n, k),
                  axis=2)
    lub2 = jnp.maximum(jnp.minimum(tr2, rs2), 1.5 * tau) * 1.02
    lub = lub2.reshape(g)

    fv = transfer_vals(lub)
    gmap, v0 = _gram_maps(m, s, nodes)
    gam = (fv @ jnp.asarray(gmap)).reshape(g, m, s)
    f0 = fv @ jnp.asarray(v0)                                 # (G,)

    # gh = 2 gram / lub - I per block, via per-block ROW scaling (exact:
    # off-diagonal entries are zero)
    scale = jnp.repeat(2.0 / lub2, k, axis=1)                 # (G2, nK)
    eye2 = jnp.eye(k2, dtype=jnp.float32)
    gh_p = gram_p * scale[:, :, None] - eye2
    mh_p = jnp.einsum("gip,gjp->gij", xn_st, xc_st,
                      preferred_element_type=jnp.float32) * mask

    # per-COLUMN coefficients: block b's columns carry group n*g+b's gam
    cvec = jnp.repeat(gam.reshape(g2, n, m, s), k, axis=1)
    cvec = jnp.transpose(cvec, (0, 2, 3, 1))                  # (G2, m, s, nK)
    g_mat = _chain_mats(gh_p, lambda i, r: cvec[:, i, r, None, :],
                        m, s, mmm, eye2)
    t_p = mmm(mh_p, g_mat)                                    # block-diag
    y = jnp.einsum("gij,gjp->gip", st(t_p), st(xc_st),
                   preferred_element_type=jnp.float32)
    y = y.reshape(g, k, p)
    return f0[:, None, None] * xn2 + y * (2.0 / (k * lub))[:, None, None]


def _poly_econ_packed(xc2, xn2, m, s, nodes, tau, cfg, transfer_vals,
                      n_pack: int = 2):
    """Matrix-regime econ evaluation with n-groups-per-matrix packing.

    The packed block-diagonal covariance is computed DIRECTLY as one
    lane-stacked (K, np)^T @ (K, np) product per n-tuple with a constant
    0/1 block mask fused into the epilogue (see _poly_econ_gram_packed for
    why this beats assembling block diagonals).  Cuts the matmul op count
    n-fold (the step-0 iphone preset runs p=49, so two groups fit a
    98-dim block-diagonal matrix).  Returns (G, K, p) filtered rows."""
    g, k, p = xn2.shape
    n = n_pack
    g2, p2 = g // n, n * p
    sdty = jnp.bfloat16 if cfg.poly_bf16 else jnp.float32

    def st(x):
        return x.astype(sdty)

    def lmm(a, b):
        return jnp.einsum("gkp,gpq->gkq", st(a), st(b),
                          preferred_element_type=jnp.float32)

    def mmm(a, b):
        return jnp.einsum("gij,gjk->gik", st(a), st(b),
                          preferred_element_type=jnp.float32)

    # lane-stacked tuples: group n*g+b in lanes [b*p:(b+1)*p]
    xc_p = jnp.transpose(xc2.reshape(g2, n, k, p),
                         (0, 2, 1, 3)).reshape(g2, k, p2)
    xn_p = jnp.transpose(xn2.reshape(g2, n, k, p),
                         (0, 2, 1, 3)).reshape(g2, k, p2)

    mask = jnp.asarray(_blockdiag_maskn(p, n))
    cov_p = jnp.einsum("gki,gkj->gij", xc_p, xc_p,
                       preferred_element_type=jnp.float32) * (mask / k)
    diag = jnp.einsum("gii->gi", cov_p)                       # (G2, np)
    tr2 = jnp.sum(diag.reshape(g2, n, p), axis=2)             # (G2, n)
    rs2 = jnp.max(jnp.sum(jnp.abs(cov_p), axis=2).reshape(g2, n, p),
                  axis=2)
    lub2 = jnp.maximum(jnp.minimum(tr2, rs2), 1.5 * tau) * 1.02
    lub = lub2.reshape(g)

    fv = transfer_vals(lub)
    gam = (fv @ jnp.asarray(_ps_basis_pinv(m, s, nodes))).reshape(g, m, s)

    scale = jnp.repeat(2.0 / lub2, p, axis=1)                 # (G2, np)
    eye2 = jnp.eye(p2, dtype=jnp.float32)
    ah_p = cov_p * scale[:, :, None] - eye2

    # per-COLUMN coefficients: block b's columns carry group (ng+b)'s gamma
    cvec = jnp.repeat(gam.reshape(g2, n, m, s), p, axis=1)    # (G2, np, m, s)
    cvec = jnp.transpose(cvec, (0, 2, 3, 1))                  # (G2, m, s, np)

    f_mat = _chain_mats(ah_p, lambda i, r: cvec[:, i, r, None, :],
                        m, s, mmm, eye2)
    y = lmm(xn_p, f_mat)                                      # (G2, K, np)
    return jnp.transpose(y.reshape(g2, k, n, p),
                         (0, 2, 1, 3)).reshape(g, k, p)
