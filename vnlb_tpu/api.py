"""Public API: ``denoise`` and ``denoise_mod``.

Parity: reference lib/vnlb/impl.py:24-132.  Differences by design:

* ``flows=`` is a real keyword argument — the reference's README documents a
  flow input that ``denoise()`` silently drops (impl.py:45 always allocates
  zeros; SURVEY.md §3.1).  Here user flows are honored; the default is zero
  flow, matching the reference's effective behavior.
* The preset is an explicit argument (default "iphone" = the reference's
  hardcoded choice, params.py:58).
* Everything runs on JAX's default device; there is no ``gpuid`` plumbing.
  A ``gpuid`` kwarg is accepted and ignored for drop-in compatibility.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax.numpy as jnp

from .config import VnlbConfig, default_config
from .pipeline import proc_nl
from .utils.timer import Timer


def _prep_flows(noisy_shape, flows):
    """Returns (fflow, bflow, zero_flow).  The flag rides along so callers
    can tell proc_nl statically — its auto-detection would copy the
    device-resident zeros back to the host."""
    if flows is None:
        # allocate the zeros ON DEVICE: no host->device copy per call
        t, _, h, w = noisy_shape
        z = jnp.zeros((t, 2, h, w), jnp.float32)
        return z, z, True
    if isinstance(flows, dict):
        fflow, bflow = flows["fflow"], flows["bflow"]
    else:
        fflow, bflow = flows
    fflow = np.asarray(fflow, np.float32)
    bflow = np.asarray(bflow, np.float32)
    t = noisy_shape[0]
    if fflow.shape[0] == t - 1:  # expand t-1 -> t (reference utils.py:136-183)
        from .utils.flow_io import expand_flows
        fflow, bflow = expand_flows(fflow, bflow)
    assert fflow.shape[0] == t and bflow.shape[0] == t, \
        f"flows must have {t} or {t - 1} frames"
    return fflow, bflow, bool(not fflow.any() and not bflow.any())


def denoise(noisy, sigma: float, flows=None, clean=None,
            preset: str = "iphone", cfg: Optional[VnlbConfig] = None,
            verbose: bool = False, gpuid: int = 0
            ) -> Tuple[jnp.ndarray, jnp.ndarray, float]:
    """Video Non-Local Bayes denoising (two passes).

    Args:
      noisy: (T, C, H, W) RGB video, [0, 255] float.
      sigma: noise standard deviation on the [0, 255] scale.
      flows: optional (fflow, bflow) pair or dict, each (T, 2, H, W) or
             (T-1, 2, H, W).  Defaults to zero flow.
      clean: optional clean video for oracle experiments.
      preset/cfg: named preset or a fully custom ``VnlbConfig``.

    Returns (deno, basic, seconds) — parity with reference impl.py:24-62.
    """
    clock = Timer().tic()
    noisy = np.asarray(noisy, np.float32) if not hasattr(noisy, "shape") \
        else noisy
    cfg = cfg or default_config(sigma, preset=preset, verbose=verbose)
    fflow, bflow, zf = _prep_flows(noisy.shape, flows)

    if verbose:
        print(f"[vnlb_tpu] preset={cfg.preset} sigma={sigma}")

    basic = proc_nl(noisy, None, clean, fflow, bflow, cfg.stage(0),
                    zero_flow=zf)
    deno = proc_nl(noisy, basic, clean, fflow, bflow, cfg.stage(1),
                   zero_flow=zf)
    deno.block_until_ready()
    return deno, basic, clock.toc()


def denoise_streaming(noisy, sigma: float, chunk: int = 12, flows=None,
                      preset: str = "iphone",
                      cfg: Optional[VnlbConfig] = None, mesh=None,
                      verbose: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Two-pass denoising of arbitrarily long videos in bounded memory.

    Each pass streams over temporal chunks of ``chunk`` output frames,
    padded with ``ctx = 2*nwt + pt - 1`` context frames per side: an output
    frame f receives contributions from sites up to ``nwt + pt - 1`` frames
    away, and those sites' search windows reach another ``nwt + pt - 1``,
    so ``2*nwt + pt - 1`` frames of context make every contributing site
    see exactly the candidates, patch groups and aggregation deposits of a
    full-video run.  The two passes stream SEPARATELY: pass 1 (basic) runs
    over the whole video first and is assembled on the host, so the pass-2
    search/centering reads globally-exact basic frames instead of a
    per-chunk recomputation (whose own context would need another
    ``2*nwt + pt - 1`` frames).  Chunk lattices are phase-anchored to
    global frame indices (``proc_nl(..., t_origin)``), so interior output
    frames match the monolithic result up to scatter-order fp rounding
    (pinned by tests/test_streaming.py on true sub-window chunks).
    First/last chunks clamp at the sequence ends like the monolithic run.

    Peak device memory is that of a (chunk + 2*ctx)-frame clip regardless
    of the video length — the column-space accumulator (~2.4 GB/frame at
    1080p) makes this the enabling mode for long/large clips; combine with
    ``mesh=`` (halo spatial sharding, parallel/halo.py) to split each
    chunk's strips across chips for the 1080p-class scale-out target
    (BASELINE.md).

    The reference reached for the same idea at the script level (its set
    runner slices videos to <=85 frames, process_video_set.py:108-117);
    here it is a first-class API with exact context accounting.

    Returns (deno, basic, seconds) as host numpy arrays.
    """
    clock = Timer().tic()
    noisy = np.asarray(noisy, np.float32)
    t_len = noisy.shape[0]
    cfg = cfg or default_config(sigma, preset=preset, verbose=verbose)
    s0, s1 = cfg.stage(0), cfg.stage(1)
    fflow, bflow, zflow = _prep_flows(noisy.shape, flows)
    if flows is None:
        # host zeros: the streaming loop slices per-chunk windows
        fflow = bflow = np.zeros((t_len, 2) + noisy.shape[2:], np.float32)
    else:
        fflow, bflow = np.asarray(fflow), np.asarray(bflow)

    if mesh is not None:
        from .parallel.halo import proc_nl_halo

        def run_pass(scfg, nz, bs, ff, bf, t0):
            return np.asarray(proc_nl_halo(nz, bs, ff, bf, scfg, mesh,
                                           t_origin=t0))
    else:
        def run_pass(scfg, nz, bs, ff, bf, t0):
            return np.asarray(proc_nl(nz, bs, None, ff, bf, scfg,
                                      zero_flow=zflow, t_origin=t0))

    def stream_pass(scfg, basic_full):
        ctx = 2 * max(scfg.nwt_b, scfg.nwt_f) + scfg.pt - 1
        out = np.empty_like(noisy)
        win = min(t_len, chunk + 2 * ctx)
        for start in range(0, t_len, chunk):
            stop = min(start + chunk, t_len)
            # fixed-size context window anchored to cover [start, stop):
            # one compiled shape for every chunk (extra context is harmless
            # — it only extends the exact-match region)
            lo = max(0, min(start - ctx, t_len - win))
            hi = lo + win
            bs = None if basic_full is None else basic_full[lo:hi]
            o = run_pass(scfg, noisy[lo:hi], bs, fflow[lo:hi], bflow[lo:hi],
                         lo)
            out[start:stop] = o[start - lo:stop - lo]
            if verbose:
                print(f"[vnlb_tpu] pass {scfg.step} streamed frames "
                      f"{start}:{stop} (ctx {lo}:{hi})")
        return out

    basic = stream_pass(s0, None)
    deno = stream_pass(s1, basic)
    return deno, basic, clock.toc()


def denoise_mod(noisy, sigma: float, flows=None, clean=None,
                verbose: bool = False, gpuid: int = 0
                ) -> Tuple[jnp.ndarray, jnp.ndarray, float]:
    """Experimental variant pipeline (reference impl.py:64-132):

    1. averaging warm start (K=10, search on noisy, 'ave' mode);
    2. three damped 'ave' iterations (alpha=0.75, K=2, search on basic);
    3. a Bayes pass with K=100 searching on basic;
    4. the final step-2 pass (K=60, gamma=0.2, cpatches=basic).
    """
    clock = Timer().tic()
    noisy = jnp.asarray(noisy, jnp.float32)
    cfg = default_config(sigma, preset="iphone", verbose=verbose)
    fflow, bflow, zflow = _prep_flows(noisy.shape, flows)

    s0 = cfg.stage(0)
    basic = proc_nl(noisy, None, clean, fflow, bflow,
                    s0.replace(npatches=10, srch_img="noisy",
                               cpatches="noisy", deno="ave"),
                    zero_flow=zflow)

    alpha = 0.75
    for _ in range(3):
        basic = alpha * basic + (1 - alpha) * noisy
        basic = proc_nl(noisy, basic, clean, fflow, bflow,
                        s0.replace(npatches=2, srch_img="basic",
                                   cpatches="noisy", deno="ave"),
                        zero_flow=zflow)

    basic = proc_nl(noisy, basic, clean, fflow, bflow,
                    s0.replace(npatches=100, srch_img="basic",
                               cpatches="noisy", deno="bayes"),
                    zero_flow=zflow)

    s1 = cfg.stage(1).replace(npatches=60, gamma=0.2, cpatches="basic")
    deno = proc_nl(noisy, basic, clean, fflow, bflow, s1, zero_flow=zflow)
    deno.block_until_ready()
    return deno, basic, clock.toc()


def proc_nl_cache(vid_set, vid_name, sigma):
    """Read a previously cached denoised sequence (reference
    proc_nl.py:179-180)."""
    from .utils.video_io import read_nl_sequence

    return read_nl_sequence(vid_set, vid_name, sigma)


def proc_nn(model: str, vid_set, vid_name, sigma):
    """Read cached NN-denoiser outputs (PaCNet/UDVD interop; reference
    proc_nn.py:5-14)."""
    from .utils import video_io

    readers = {"udvd": video_io.read_udvd_sequence,
               "pacnet": video_io.read_pacnet_sequence,
               "vnlb": video_io.read_nl_sequence}
    if model not in readers:
        raise ValueError(f"unknown nn model [{model}]")
    return readers[model](vid_set, vid_name, sigma)
