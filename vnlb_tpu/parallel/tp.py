"""Tensor parallelism: the Bayes/Wiener filter batch sharded across chips.

SURVEY.md §2.3 TP: shard the patch-group filter's batch dimension across the
mesh when a site batch's groups exceed one chip's appetite.  The filter is
embarrassingly parallel over groups (each group owns its covariance,
eigendecomposition / polynomial chain, and projection — reference
lib/vnlb/deno/bayes_est.py:17-62 loops them on one GPU), so the
decomposition is exact: ``shard_map`` over the group axis, no collectives
inside, one all-gather implied by the replicated out-spec only if the
caller asks for it.

This axis composes with site-DP (parallel/tiled.py): DP shards SITES before
the search; TP shards the filter batch of one site batch.  The practical
use is groups >> one device's single-batch filtering (e.g. offline re-filtering of
precomputed groups at K=100, p=147), where the full (G, K, p) operand set
exceeds one chip.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import StageConfig


@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "axis"))
def _bayes_tp_jit(pnoisy, pbasic, flat, cfg: StageConfig, mesh: Mesh,
                  axis: str):
    from ..ops.bayes import bayes_denoise

    step2 = cfg.step == 1

    def shard_fn(pn, pb, fl):
        out, rvar = bayes_denoise(pn, pb if step2 else None,
                                  fl if step2 else None, cfg)
        return out, rvar

    spec = P(axis)
    return jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=(spec, spec),
    )(pnoisy, pbasic, flat)


def bayes_denoise_tp(pnoisy, pbasic, flat, cfg: StageConfig, mesh: Mesh
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """``ops.bayes.bayes_denoise`` with the group batch sharded over ``mesh``.

    Args match bayes_denoise: pnoisy/pbasic (B, K, pt, c, ps, ps), flat (B,).
    The batch is zero-padded to a multiple of the mesh size (padded groups
    are filtered like real ones and stripped before returning — their
    content is all-zero patches, which the filter maps to zeros).
    Results equal the unsharded call exactly (pinned by tests/test_tp.py).
    """
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    b = pnoisy.shape[0]
    pad = (-b) % n_dev

    pnoisy = jnp.asarray(pnoisy, jnp.float32)
    pbasic = (jnp.zeros_like(pnoisy) if pbasic is None
              else jnp.asarray(pbasic, jnp.float32))
    flat = (jnp.zeros((b,), bool) if flat is None
            else jnp.asarray(flat, bool))
    if pad:
        zpatch = jnp.zeros((pad,) + pnoisy.shape[1:], pnoisy.dtype)
        pnoisy = jnp.concatenate([pnoisy, zpatch], axis=0)
        pbasic = jnp.concatenate([pbasic, zpatch], axis=0)
        flat = jnp.concatenate([flat, jnp.zeros((pad,), bool)], axis=0)

    out, rvar = _bayes_tp_jit(pnoisy, pbasic, flat, cfg, mesh, axis)
    return out[:b], rvar[:b]
