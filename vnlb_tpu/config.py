"""Configuration system for the VNLB pipeline.

Re-design of the reference flag system (reference: lib/vnlb/params.py:11-100):
the reference keeps a dict of ``[step0, step1]`` lists plus a hidden hardcoded
preset string (``params.py:58``).  Here every knob is an explicit frozen
dataclass field; presets are named constructors and the preset is an explicit
argument of the public API.  A frozen, hashable config doubles as the static
argument for ``jax.jit`` so that each (video-shape, stage-config) pair compiles
exactly once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

PRESETS = ("default", "exp", "sss", "sss_v2", "iphone")


@dataclasses.dataclass(frozen=True)
class StageConfig:
    """All parameters of ONE denoising pass (reference: params.py:11-50 picks
    the ``[step]`` element of each 2-list via VnlbArgs, params.py:102-214).

    Shapes/semantics notes
    ----------------------
    * ``ps``/``pt``       : spatial / temporal patch size (sizePatch/-Time).
    * ``npatches``        : K, the number of similar patches per group.
    * ``w_s``             : spatial search window diameter (sizeSearchWindow).
    * ``nwt_f``/``nwt_b`` : forward/backward temporal search radius.
    * ``rank``            : retained eigenvector count (low-rank prior).
    * ``thresh``          : eigenvalue gate multiplier (variThres).
    * ``gamma``           : flat-area variance threshold multiplier.
    * ``offset``          : bias subtracted from normalized patch distances.
    * ``step_s``          : coverage-lattice stride (procStep).
    * ``dist_chnls``      : channels used by the patch distance (the C++
                            algorithm searches on Y only in step 0 and on all
                            channels of the basic estimate in step 1).
    * ``tau``             : similarity threshold (C++ VNLB semantics): when
                            > 0, candidates whose mean per-pixel squared
                            distance exceeds tau are invalidated (ind = -1,
                            excluded from aggregation).  tau = 400 means an
                            RMS pixel difference of 20 on the search image.
                            0 disables (the reference's effective behavior —
                            it declares tau but never reads it).
    * ``beta``            : multiplier on sigma_basic^2 in the eigenvalue
                            shrinkage (reference bayes_est_old.py:53).
    * ``only_frame``      : when >= 0, aggregate only into this frame
                            (reference comp_agg.py:234 legacy semantics).
    * ``couple_channels`` : estimate ONE joint prior over all channels
                            (patch dim becomes c*pt*ps^2) instead of a
                            per-channel prior (reference params.py:173-179).
    * ``aggre_boost``     : consumed by the random-mask compat mode
                            (vnlb_tpu/compat.py): dilate the processed-site
                            set by the paste trick (reference
                            mask.py:104-187); the deterministic lattice
                            pipeline has no random mask to boost.
    """

    step: int
    sigma: float
    sigma_basic: float
    ps: int = 7
    pt: int = 2
    npatches: int = 100
    agg_k: int = 0                  # aggregate only the best agg_k of the K
                                    # patches (0 = all K).  The Bayes prior
                                    # still uses all K; this only thins the
                                    # scatter (the pipeline's row-write
                                    # bill is ~linear in it).  Quality
                                    # frontier: docs/COMPARE.md
    agg_weight: str = "uniform"     # "uniform" (reference semantics) |
                                    # "exp": NLM-style distance weighting
                                    # exp(-d / (agg_h * sigma^2)) of each
                                    # aggregated patch.  Measured neutral
                                    # (+-0.01 dB) at sigma=20 — the
                                    # Wiener-FILTERED patches are already
                                    # denoised, unlike raw-patch NLM
    agg_h: float = 4.0              # bandwidth of the "exp" weighting,
                                    # in units of sigma^2
    w_s: int = 27
    nwt_f: int = 6
    nwt_b: int = 6
    rank: int = 39
    thresh: float = 2.7
    gamma: float = 0.95
    beta: float = 1.0
    tau: float = 0.0
    offset: float = 0.0
    flat_areas: bool = False
    couple_channels: bool = False
    aggre_boost: bool = True
    nkeep: int = -1                 # compat mode: only the first nkeep
                                    # matches dilate the work mask
                                    # (reference mask.py:49-50); -1 = all
    step_s: int = 3
    only_frame: int = -1
    mod_sel: str = "clipped"        # eigenvalue shrinkage mode
    stype: str = "l2"               # "l2" | "needle"
    srch_img: str = "noisy"         # image searched: "noisy"|"basic"|"clean"
    cpatches: str = "noisy"         # image the covariance is estimated from
    deno: str = "bayes"             # "bayes" | "ave"
    dist_chnls: int = 1             # channels entering the patch distance
    bsize: int = 256                # sites per lax.scan step (batch)
    needle_scales: int = 3          # pyramid levels for stype == "needle"
    topk: str = "exact"             # dense-path K selection: "exact"
                                    # (one-shot) | "stream" (per-dt merge,
                                    # bit-equal, ~14x less peak memory) |
                                    # "approx" (lax.approx_max_k)
    border_mode: str = "slide"      # zero-flow border handling: "slide" =
                                    # the C++ sliding window (exact; border
                                    # sites take the slow per-site path) |
                                    # "mask" = out-of-bounds candidates
                                    # masked +inf (every site rides the
                                    # dense fast path; the top-K near
                                    # borders picks from fewer candidates)
    dense_rows: str = "auto"        # dense-path level-0 row coverage:
                                    # "auto" = strided-query rows when the
                                    # pipeline passes the lattice phases
                                    # (only ~1/step_s of rows hold queries)
                                    # | "full" = distances at every row
                                    # (arbitrary-site callers; verification)
    cols_bf16: bool = True          # store patch columns in bf16 (halves
                                    # the column arena + gather traffic;
                                    # patch pixels quantize ~0.2 RMS vs
                                    # sigma>=10 noise — measured ZERO PSNR
                                    # change at 3 decimals; patches upcast
                                    # to f32 right after the gather)
    eig_method: str = "jacobi"      # "jacobi" | "xla" | "rational" | "poly"
    eig_sweeps: int = 8             # cyclic-Jacobi sweeps (fp32 converges ~6-8)
    gate_power: int = 1             # rational-gate sharpness (1 or 2)
    gate_scale: float = 1.0         # rational-gate center, x tau (tuned:
                                    # two-pass deno within +-0.05 dB of exact)
    ns_iters: int = 14              # poly path: Newton-Schulz sign-gate
                                    # iterations (transition width ~1.5^-n)
    poly_deg: int = 12              # poly path: Chebyshev degree of the
                                    # smooth Wiener factor
    poly_bf16: bool = True          # poly path: store iteration matrices in
                                    # bf16 between matmuls (halves the
                                    # phase's memory traffic; the matmuls
                                    # run at default precision)
    poly_econ: bool = True          # evaluate the fused series with the
                                    # T_s-substitution + Clenshaw scheme
                                    # (~half the matmul ops; identical
                                    # polynomial space) — both regimes
    poly_fused: bool = True         # K < p regime: evaluate the WHOLE
                                    # gate x Wiener transfer as one
                                    # Chebyshev series through the
                                    # left-side recurrence (zero (p,p)@(p,p)
                                    # matmuls) instead of sign-gate + factor
    poly_deg_fused: int = 28        # degree of the fused series (measured
                                    # on the 40x40 exact-eigh pin clip:
                                    # 16/20/24/28 all within +0.03 dB of
                                    # exact; presets run 16)
    poly_gram: bool = True          # K < p regime: evaluate the econ chain
                                    # in the K-dim GRAM domain (exact
                                    # polynomial division of the fitted
                                    # series, ops/polyspec._gram_maps) —
                                    # K x K matrices instead of p x p
    poly_pack2: bool = True         # matrix-regime econ path: pack TWO
                                    # groups per block-diagonal matrix when
                                    # 2p <= 128 (halves the matmul op count
                                    # at identical math)
    search_bf16: bool = True        # store the dense per-dt candidate
                                    # planes in bf16 between the distance
                                    # scan and the per-site row take
                                    # (halves the stored planes, the
                                    # layout transpose and the take
                                    # traffic; values upcast to f32 before
                                    # the offset/top-K math).  Distances
                                    # round ~0.4% relative — near-tie
                                    # candidates can swap (measured
                                    # -0.0007/+0.0001 dB end-to-end at
                                    # 480p; GPU speed effect not measured).
                                    # Quality gate in tests/test_knobs.py
                                    # (set False for f32 candidate planes)
    agg_bf16: bool = False          # stack the deferred-scatter update rows
                                    # in bf16 (halves the scan's stacked-
                                    # update buffer; the f32 accumulator
                                    # adds exactly after an upcast) — a
                                    # MEMORY knob for long streaming
                                    # windows; GPU speed effect not
                                    # measured.  Quality gate:
                                    # tests/test_knobs.py

    # -- derived --
    @property
    def sigma2(self) -> float:
        return self.sigma ** 2

    @property
    def sigmab2(self) -> float:
        """Basic-noise variance entering the eigenvalue shrinkage, scaled by
        ``beta`` (reference intent: bayes_est_old.py:53 ``sigmab2 = beta *
        sigmaBasic2``; the live reference code fixes beta = 1)."""
        return self.beta * self.sigma_basic ** 2

    @property
    def n_dt(self) -> int:
        """Temporal window size (number of frames scanned)."""
        return self.nwt_b + self.nwt_f + 1

    @property
    def n_cands(self) -> int:
        """Candidates per query site (static)."""
        return self.n_dt * self.w_s * self.w_s

    @property
    def pdim(self) -> int:
        """Per-channel patch dimension entering the Bayes filter."""
        return self.pt * self.ps * self.ps

    def replace(self, **kw) -> "StageConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class VnlbConfig:
    """Two-stage VNLB configuration (reference: params.py:52-100)."""

    sigma: float
    stages: Tuple[StageConfig, ...]
    preset: str = "default"
    verbose: bool = False

    def stage(self, i: int) -> StageConfig:
        return self.stages[i]


def default_config(sigma: float, preset: str = "iphone", verbose: bool = False,
                   **overrides) -> VnlbConfig:
    """Build the two-stage config.

    ``preset`` mirrors the reference's named versions (params.py:54-91); the
    reference hardcodes ``"iphone"`` — here it is an argument with the same
    default so `denoise(noisy, sigma)` behaves like the reference.

    ``overrides`` are applied to both stages when scalar, or per-stage when a
    2-list/2-tuple is given (matching the reference's `[step0, step1]` flag
    style).
    """
    if preset not in PRESETS:
        raise ValueError(f"unknown preset [{preset}]; options: {PRESETS}")

    offset0 = 2.0 * (sigma / 255.0) ** 2
    base = dict(sigma=float(sigma))

    # sigma-adaptive fused-series degree: the econ gate's transition width
    # is ~1.2*(pi/deg)*sqrt(tau*lub) with tau = thresh*sigma^2 (+sigmab^2),
    # so holding width/tau ~ constant needs deg ~ 1/sqrt(tau) ~ 1/sigma^?;
    # measured on the exact-eigh pin clip (a poly_deg_fused sweep):
    # sigma=10 needs deg>=24 for the <=0.1 dB basic budget (16 leaks 0.135),
    # sigma=40 already holds it at 12.  deg = 16*sqrt(20/sigma), mult of 4,
    # reproduces 24/16/12 at sigma 10/20/40 (pinned by the test_polyspec
    # sigma sweep).
    deg_f = int(min(32, max(8, -(-16.0 * (20.0 / max(sigma, 1.0)) ** 0.5
                                 // 4) * 4)))

    # agg_k=32: aggregate only the 32 closest of the K patches.  Measured
    # quality frontier (96x96 sigma=20 two-pass): 0 (all K) -> 29.23/29.16,
    # 48 -> 29.38/29.23, 32 -> 29.40/29.25, 16 -> 29.38/29.24 dB — the
    # farthest "similar" patches hurt the average, so thinning the scatter
    # improves BOTH speed (~K/32 fewer scatter rows) and PSNR.  Set
    # agg_k=0 for the reference's aggregate-all-K semantics.
    # poly-filter schedule ns_iters=10/poly_deg=8 (both stages): cheapest
    # schedule inside the <=0.1 dB exact-eigh budget — measured on the
    # 40x40 pin clip: 10/8 -> +0.001/+0.036 dB vs exact, 8/6 ->
    # -0.15/-0.25 (too cheap); 96x96 two-pass PSNR flat across all of
    # them.  cols_bf16 halves gather/scatter column traffic at +0.002 dB.
    # eig_method="poly": the production spectral filter (within the 0.1 dB
    # exact-eigh budget, tests/test_polyspec) — exact modes ("jacobi",
    # "xla") remain one replace() away for verification
    s0 = dict(base, step=0, sigma_basic=float(sigma), npatches=100, gamma=0.95,
              thresh=2.7, tau=0.0, flat_areas=False, offset=offset0,
              srch_img="noisy", cpatches="noisy", dist_chnls=1, agg_k=32,
              eig_method="poly", ns_iters=10, poly_deg=8, poly_deg_fused=deg_f,
              cols_bf16=True)
    # stage 1 poly knobs: the covariance source is the (nearly clean) basic
    # estimate, whose spectrum has a wide gap at tau — fewer sign iterations
    # and a lower Wiener degree hold the <=0.1 dB budget (test_polyspec)
    # tau: the reference DECLARES [0, 400] (params.py:40) but no live op
    # reads it (its GPU search fixed the group size at K) — here tau is a
    # real knob (see StageConfig.tau), so the default is "off" to match the
    # reference's effective behavior; set tau=[0, 400] to enable the
    # original C++ similarity threshold.
    s1 = dict(base, step=1, sigma_basic=0.0, npatches=60, gamma=0.2,
              thresh=0.7, tau=0.0, flat_areas=True, offset=0.0,
              srch_img="basic", cpatches="basic", dist_chnls=3,
              eig_method="poly", ns_iters=10, poly_deg=8, poly_deg_fused=deg_f,
              agg_k=32, cols_bf16=True)

    if preset in ("sss", "sss_v2", "iphone"):
        for s in (s0, s1):
            s.update(w_s=15, nwt_f=10, nwt_b=10)
    if preset == "sss_v2":
        s0.update(pt=1)
    if preset == "iphone":
        s0.update(pt=1, stype="needle")

    for k, v in overrides.items():
        vals = v if isinstance(v, (list, tuple)) else (v, v)
        s0[k], s1[k] = vals[0], vals[1]

    stages = (StageConfig(**s0), StageConfig(**s1))
    return VnlbConfig(sigma=float(sigma), stages=stages, preset=preset,
                      verbose=verbose)
