"""Pipeline parallelism: the two VNLB passes on two devices, overlapped.

SURVEY.md §2.3 PP: the reference runs its two passes strictly sequentially
(reference lib/vnlb/impl.py:47-57 — pass 2 starts only after pass 1 finished
the whole video).  On a multi-device host the passes can instead form a
software pipeline over temporal chunks: device 0 runs pass 1 (basic) on
chunk j while device 1 runs pass 2 (final) on chunk j-L, overlapping the
two passes' compute almost completely for long videos.

The chunk/context window math is IDENTICAL to ``api.denoise_streaming``
(ctx = 2*nwt + pt - 1 per pass, fixed compiled window size, global lattice
phase anchoring), and pass 2 reads exactly the same finalized basic frames,
so the output is bit-identical to ``denoise_streaming`` on the same chunking
(pinned by tests/test_pipe.py).  The lag L = ceil(ctx2 / chunk) chunks is
the smallest offset such that every basic frame pass 2 needs is final.

Scheduling uses JAX's asynchronous dispatch: pass-1 chunk j+1 is enqueued
on device 0 BEFORE fetching chunk j's result, so the host-side fetch /
re-shipment of basic frames to device 1 overlaps device 0's next chunk.
No collectives are involved — the inter-stage edge is a (chunk-window,
C, H, W) device-to-device transfer, which rides ICI when both devices are
chips of one slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..config import VnlbConfig, default_config
from ..utils.timer import Timer


def _pass_ctx(scfg) -> int:
    return 2 * max(scfg.nwt_b, scfg.nwt_f) + scfg.pt - 1


def _windows(t_len: int, chunk: int, ctx: int):
    """The streaming window list [(start, stop, lo, hi), ...] — same math
    as api.denoise_streaming.stream_pass."""
    win = min(t_len, chunk + 2 * ctx)
    out = []
    for start in range(0, t_len, chunk):
        stop = min(start + chunk, t_len)
        lo = max(0, min(start - ctx, t_len - win))
        out.append((start, stop, lo, lo + win))
    return out


def denoise_pipelined(noisy, sigma: float, chunk: int = 12, flows=None,
                      preset: str = "iphone",
                      cfg: Optional[VnlbConfig] = None, devices=None,
                      meshes=None, verbose: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Two-pass denoising with the passes pipelined across two devices.

    ``devices``: a (pass1_device, pass2_device) pair; defaults to the first
    two of ``jax.devices()`` (falls back to single-device overlap — still
    correct, JAX just serializes the streams — when only one exists).

    ``meshes``: optional (mesh1, mesh2) pair of DISJOINT device meshes —
    the PP x SP composition: each pass runs halo-SP sharded over ITS mesh
    (parallel/halo.proc_nl_halo) while the two passes pipeline over
    temporal chunks (e.g. 8 devices = 2 pipeline stages x 4 H-strips).
    Overrides ``devices``.

    Returns (deno, basic, seconds) as host numpy arrays; equals
    ``denoise_streaming(noisy, sigma, chunk=chunk, ...)`` exactly
    (to halo-SP fp reassociation when ``meshes`` is given).
    """
    import jax
    import jax.numpy as jnp

    from ..api import _prep_flows
    from ..pipeline import proc_nl

    clock = Timer().tic()
    noisy = np.asarray(noisy, np.float32)
    t_len = noisy.shape[0]
    cfg = cfg or default_config(sigma, preset=preset, verbose=verbose)
    s0, s1 = cfg.stage(0), cfg.stage(1)
    fflow, bflow, zflow = _prep_flows(noisy.shape, flows)
    if flows is None:
        fflow = bflow = np.zeros((t_len, 2) + noisy.shape[2:], np.float32)
    else:
        fflow, bflow = np.asarray(fflow), np.asarray(bflow)

    if devices is None:
        devs = jax.devices()
        devices = (devs[0], devs[1 % len(devs)])
    d0, d1 = devices

    ctx1, ctx2 = _pass_ctx(s0), _pass_ctx(s1)
    w1 = _windows(t_len, chunk, ctx1)
    w2 = _windows(t_len, chunk, ctx2)
    n_chunks = len(w1)
    lag = max(1, -(-ctx2 // chunk))

    basic = np.empty_like(noisy)
    deno = np.empty_like(noisy)
    basic_final = -1                      # highest finalized basic frame + 1
    p1_pending = []                       # [(j, device_array)]
    p2_pending = []

    if meshes is not None:
        from .halo import proc_nl_halo

        mesh1, mesh2 = meshes

    def dispatch_p1(j):
        start, stop, lo, hi = w1[j]
        if meshes is not None:
            o = proc_nl_halo(noisy[lo:hi], None, fflow[lo:hi], bflow[lo:hi],
                             s0, mesh1, t_origin=lo)
        else:
            with jax.default_device(d0):
                o = proc_nl(jnp.asarray(noisy[lo:hi]), None, None,
                            fflow[lo:hi], bflow[lo:hi], s0, t_origin=lo)
        p1_pending.append((j, o))

    def drain_p1():
        """Fetch the oldest in-flight pass-1 chunk into the basic buffer."""
        nonlocal basic_final
        j, o = p1_pending.pop(0)
        start, stop, lo, hi = w1[j]
        basic[start:stop] = np.asarray(o)[start - lo:stop - lo]
        basic_final = stop
        if verbose:
            print(f"[pipe] pass 1 chunk {j} final (frames {start}:{stop})")

    def dispatch_p2(i):
        start, stop, lo, hi = w2[i]
        assert basic_final >= hi, (basic_final, hi)
        if meshes is not None:
            o = proc_nl_halo(noisy[lo:hi], basic[lo:hi], fflow[lo:hi],
                             bflow[lo:hi], s1, mesh2, t_origin=lo)
        else:
            with jax.default_device(d1):
                o = proc_nl(jnp.asarray(noisy[lo:hi]),
                            jnp.asarray(basic[lo:hi]),
                            None, fflow[lo:hi], bflow[lo:hi], s1,
                            t_origin=lo)
        p2_pending.append((i, o))

    def drain_p2():
        i, o = p2_pending.pop(0)
        start, stop, lo, hi = w2[i]
        deno[start:stop] = np.asarray(o)[start - lo:stop - lo]
        if verbose:
            print(f"[pipe] pass 2 chunk {i} final (frames {start}:{stop})")

    # software pipeline: at step j, device 0 computes pass-1 chunk j while
    # the host drains chunk j-1 and device 1 computes the newest pass-2
    # chunk whose basic context is final (steady state: chunk j - lag)
    p2_next = 0
    for j in range(n_chunks):
        dispatch_p1(j)                     # enqueue BEFORE draining j-1:
        if j >= 1:                         # d0 starts j while the host
            drain_p1()                     # fetches/reships chunk j-1
        while p2_next < n_chunks and basic_final >= w2[p2_next][3]:
            dispatch_p2(p2_next)
            p2_next += 1
        while len(p2_pending) > 1:         # bounded in-flight memory
            drain_p2()
    while p1_pending:
        drain_p1()
    while p2_next < n_chunks:              # tail chunks (basic now complete)
        dispatch_p2(p2_next)
        p2_next += 1
    while p2_pending:
        drain_p2()

    return deno, basic, clock.toc()
