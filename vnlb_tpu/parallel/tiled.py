"""Multi-chip execution over a ``jax.sharding.Mesh``.

The reference is strictly single-GPU (SURVEY.md §2.3); this module supplies
the scale-out axes this build adds:

* ``proc_nl_sharded`` — **site parallelism** (the DP axis): the coverage
  lattice's site batches are sharded across the mesh, the video is
  replicated, and every chip accumulates a partial (deno, weights) pair that
  is ``psum``-reduced over ICI before normalization.  Site groups are
  independent, so this is an exact (bitwise-deterministic per mesh size)
  decomposition — the multi-device analog of the reference's "pixel-site batch"
  parallelism (search/search.py:38-64), scaled across chips.
* ``denoise_sharded`` — two-pass driver on top of it.

Spatial tiling with halo exchange (`ppermute`, SURVEY.md §5 long-context) is
the planned second axis for videos too large for one chip's HBM.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import StageConfig, VnlbConfig, default_config
from ..ops import agg, color
from ..pipeline import accumulate, plan_sites, select_search_image


def make_mesh(n_devices: Optional[int] = None, axis: str = "sites",
              devices=None) -> Mesh:
    """1-D mesh over the first n devices, or over an explicit device list
    (``devices=``) — the latter lets disjoint device groups form separate
    meshes (e.g. pipeline-parallel passes each on their own halo mesh)."""
    devs = list(devices) if devices is not None else jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


@functools.partial(jax.jit, static_argnames=("cfg", "shape", "mesh",
                                             "n_dense_batches", "qrow0"))
def _proc_nl_sharded_jit(noisy, basic, clean, fflow, bflow, site_batches,
                         valid_batches, cfg: StageConfig, shape, mesh: Mesh,
                         n_dense_batches: int = 0, qrow0=None):
    noisy_yuv = color.rgb2yuv(noisy)
    basic_yuv = color.rgb2yuv(basic)
    clean_yuv = color.rgb2yuv(clean)
    srch = select_search_image(noisy_yuv, basic_yuv, clean_yuv, cfg)

    def shard_fn(n_yuv, b_yuv, s_yuv, ff, bf, sb, vb):
        # accumulate folds per-device partial images; fold is linear, so the
        # psum gives the exact single-device accumulators.  The dense
        # shared-candidate search fast path is per-device (its candidate
        # distances depend on the replicated video only), so each device
        # runs it on its shard of the interior sites — including the
        # production strided-query search (``qrow0``; every shard's sites
        # are global lattice sites, so the global phase tuple applies
        # unchanged and the sharded path runs the single-device search).
        deno_img, wts_img = accumulate(n_yuv, b_yuv, s_yuv, ff, bf, sb, vb,
                                       cfg, shape, axis_name="sites",
                                       n_dense_batches=n_dense_batches,
                                       qrow0=qrow0)
        deno_img = jax.lax.psum(deno_img, "sites")
        wts_img = jax.lax.psum(wts_img, "sites")
        return deno_img, wts_img

    deno_img, wts_img = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(),
                  P(None, "sites", None), P(None, "sites")),
        out_specs=(P(), P()),
    )(noisy_yuv, basic_yuv, srch, fflow, bflow, site_batches, valid_batches)

    fallback = basic_yuv if cfg.step == 1 else noisy_yuv
    deno_yuv = agg.finalize_img(deno_img, wts_img, fallback)
    return color.yuv2rgb(deno_yuv)


def proc_nl_sharded(noisy, basic, clean, fflow, bflow, cfg: StageConfig,
                    mesh: Mesh, zero_flow: Optional[bool] = None
                    ) -> jnp.ndarray:
    from ..utils.index import check_codec_range

    noisy = jnp.asarray(noisy, jnp.float32)
    shape = tuple(int(s) for s in noisy.shape)
    check_codec_range(shape)
    basic = noisy if basic is None else jnp.asarray(basic, jnp.float32)
    clean = noisy if clean is None else jnp.asarray(clean, jnp.float32)
    if zero_flow is None:
        zero_flow = (not np.any(np.asarray(fflow))
                     and not np.any(np.asarray(bflow)))
    fflow = jnp.asarray(fflow, jnp.float32)
    bflow = jnp.asarray(bflow, jnp.float32)

    n_dev = mesh.devices.size
    # per-scan batch must split evenly over chips
    bsize = ((cfg.bsize + n_dev - 1) // n_dev) * n_dev
    cfg_pad = cfg.replace(bsize=bsize)
    sb, vb, n_dense = plan_sites(shape, cfg_pad, zero_flow)
    # coverage-lattice phase rows — the production strided-query smat path
    # (same computation as pipeline.proc_nl; the video is replicated, so
    # global phases hold on every shard)
    qrow0 = None
    if zero_flow and n_dense:
        end_t = shape[0] - cfg.pt + 1
        qrow0 = tuple((f % cfg.step_s) if f < end_t - 1 else 0
                      for f in range(end_t))
    return _proc_nl_sharded_jit(noisy, basic, clean, fflow, bflow,
                                jnp.asarray(sb), jnp.asarray(vb),
                                cfg_pad, shape, mesh,
                                n_dense_batches=n_dense, qrow0=qrow0)


def denoise_sharded(noisy, sigma: float, mesh: Optional[Mesh] = None,
                    flows=None, preset: str = "iphone",
                    cfg: Optional[VnlbConfig] = None
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Two-pass VNLB with site batches sharded across the mesh."""
    from ..api import _prep_flows

    mesh = mesh or make_mesh()
    cfg = cfg or default_config(sigma, preset=preset)
    fflow, bflow, zf = _prep_flows(noisy.shape, flows)
    basic = proc_nl_sharded(noisy, None, None, fflow, bflow, cfg.stage(0),
                            mesh, zero_flow=zf)
    deno = proc_nl_sharded(noisy, basic, None, fflow, bflow, cfg.stage(1),
                           mesh, zero_flow=zf)
    return deno, basic
