"""The formerly-declarative config knobs are real: tau, beta, only_frame,
couple_channels (no silently-ignored config fields).

Reference anchors: tau params.py:40 (C++ similarity threshold), beta
bayes_est_old.py:53, onlyFrame comp_agg.py:234, coupleChannels
params.py:173-179.
"""

import numpy as np
import jax.numpy as jnp

from vnlb_tpu.config import default_config
from vnlb_tpu.ops.bayes import bayes_denoise
from vnlb_tpu.ops.search import exec_search
from vnlb_tpu.pipeline import proc_nl
from vnlb_tpu.testing.data import add_noise, synthetic_video
from vnlb_tpu.utils.metrics import compute_psnr


def _clip(t=3, h=48, w=48, sigma=20.0, seed=0):
    clean = synthetic_video(t, h, w, seed=seed)
    noisy = add_noise(clean, sigma, seed=seed + 1)
    zf = np.zeros((t, 2, h, w), np.float32)
    return clean, noisy, zf


def test_tau_invalidates_distant_candidates():
    clean, noisy, zf = _clip()
    cfg = default_config(20.0, preset="iphone").stage(0).replace(
        w_s=9, npatches=40, stype="l2")
    sites = jnp.asarray([[1, 20, 20], [0, 8, 30]], jnp.int32)
    vals, inds0 = exec_search(jnp.asarray(noisy), sites, jnp.asarray(zf),
                              jnp.asarray(zf), cfg)
    # tiny tau: only near-exact matches survive; the query itself
    # (val = -offset) always does
    cfg_t = cfg.replace(tau=1.0)
    vals_t, inds_t = exec_search(jnp.asarray(noisy), sites, jnp.asarray(zf),
                                 jnp.asarray(zf), cfg_t)
    np.testing.assert_array_equal(np.asarray(vals), np.asarray(vals_t))
    tau_n = 1.0 / 255.0 ** 2 - cfg.offset
    expect = np.where(np.asarray(vals) > tau_n, -1, np.asarray(inds0))
    np.testing.assert_array_equal(np.asarray(inds_t), expect)
    assert (np.asarray(inds_t) == -1).any()          # something was cut
    assert (np.asarray(inds_t)[:, 0] >= 0).all()     # self-match survives


def test_beta_scales_basic_variance():
    cfg = default_config(20.0).stage(0)
    assert cfg.sigmab2 == cfg.sigma_basic ** 2
    assert cfg.replace(beta=0.5).sigmab2 == 0.5 * cfg.sigma_basic ** 2
    # beta changes the filter output (shrinkage strength)
    rng = np.random.default_rng(0)
    pn = rng.normal(100, 20, (4, 100, 1, 3, 7, 7)).astype(np.float32)
    out1, _ = bayes_denoise(jnp.asarray(pn), None, None,
                            cfg.replace(pt=1, eig_method="xla"))
    out2, _ = bayes_denoise(jnp.asarray(pn), None, None,
                            cfg.replace(pt=1, eig_method="xla", beta=0.1))
    assert not np.allclose(np.asarray(out1), np.asarray(out2))


def test_only_frame_restricts_aggregation():
    clean, noisy, zf = _clip()
    cfg = default_config(20.0, preset="iphone").stage(0).replace(only_frame=1)
    out = np.asarray(proc_nl(noisy, None, None, zf, zf, cfg))
    # frames != 1 never receive aggregated patches -> zero weights ->
    # fallback to the noisy input (proc_nl epilogue)
    np.testing.assert_allclose(out[0], noisy[0], atol=1e-3)
    np.testing.assert_allclose(out[2], noisy[2], atol=1e-3)
    assert not np.allclose(out[1], noisy[1], atol=1.0)  # frame 1 denoised


def test_couple_channels_joint_prior():
    clean, noisy, zf = _clip(sigma=20.0)
    cfg = default_config(20.0, preset="iphone").stage(0)
    out_sep = np.asarray(proc_nl(noisy, None, None, zf, zf, cfg))
    out_cc = np.asarray(proc_nl(noisy, None, None, zf, zf,
                                cfg.replace(couple_channels=True)))
    assert out_cc.shape == out_sep.shape
    assert not np.allclose(out_cc, out_sep)            # different prior
    # both denoise
    assert compute_psnr(out_cc, clean) > compute_psnr(noisy, clean) + 2.0
    assert compute_psnr(out_sep, clean) > compute_psnr(noisy, clean) + 2.0


def test_agg_k_thins_aggregation():
    """agg_k aggregates only the closest patches; agg_k >= K is a no-op.

    Quality frontier (why the presets default agg_k=32): see config.py
    default_config and docs/COMPARE.md.
    """
    clean, noisy, zf = _clip()
    cfg_all = default_config(20.0, preset="iphone", agg_k=[0, 0]).stage(0)
    cfg_k = cfg_all.replace(agg_k=16)
    cfg_noop = cfg_all.replace(agg_k=cfg_all.npatches)

    out_all = np.asarray(proc_nl(noisy, None, None, zf, zf, cfg_all))
    out_k = np.asarray(proc_nl(noisy, None, None, zf, zf, cfg_k))
    out_noop = np.asarray(proc_nl(noisy, None, None, zf, zf, cfg_noop))

    np.testing.assert_array_equal(out_all, out_noop)
    assert np.abs(out_all - out_k).max() > 1e-3   # thinning changes output
    # and does not hurt quality (measured: it helps)
    p_all = compute_psnr(out_all, clean)
    p_k = compute_psnr(out_k, clean)
    assert p_k > p_all - 0.3, (p_all, p_k)


def test_agg_weight_exp():
    """agg_weight='exp' weights aggregated patches by distance; it changes
    the output (weighted mean) and stays within the uniform mode's quality
    (measured ~neutral — see config.py)."""
    clean, noisy, zf = _clip()
    cfg_u = default_config(20.0, preset="iphone").stage(0)
    cfg_e = cfg_u.replace(agg_weight="exp", agg_h=2.0)
    out_u = np.asarray(proc_nl(noisy, None, None, zf, zf, cfg_u))
    out_e = np.asarray(proc_nl(noisy, None, None, zf, zf, cfg_e))
    assert np.abs(out_u - out_e).max() > 1e-3
    p_u, p_e = compute_psnr(out_u, clean), compute_psnr(out_e, clean)
    assert abs(p_u - p_e) < 0.3, (p_u, p_e)


def test_search_bf16_planes():
    """search_bf16 (the default) stores the dense candidate planes
    in bf16 between the search kernel and the row take: distances round
    ~0.4% relative, so near-tie candidates can swap, but end-to-end quality
    must hold (the 480p bench A/B measured -0.0007/+0.0001 dB; gate here at
    <=0.05 dB).  Also asserts the knob is actually plumbed: the bf16 and
    f32 plane paths must produce different outputs on a noisy clip (if the
    cast is ever dropped, both runs become identical and this fails)."""
    clean, noisy, zf = _clip()
    cfg = default_config(20.0, preset="iphone").stage(0)
    assert cfg.search_bf16                       # the default is ON
    out_b = np.asarray(proc_nl(noisy, None, None, zf, zf, cfg))
    out_f = np.asarray(proc_nl(noisy, None, None, zf, zf,
                               cfg.replace(search_bf16=False)))
    assert np.abs(out_f - out_b).max() > 0       # the cast reaches the path
    p_f = compute_psnr(out_f, clean)
    p_b = compute_psnr(out_b, clean)
    assert abs(p_f - p_b) <= 0.05, (p_f, p_b)


def test_agg_bf16_stack():
    """agg_bf16 stacks the deferred-scatter updates in bf16: output changes
    only by the bf16 rounding of the filtered patch values (the f32
    accumulator itself is unchanged), gated at <=0.05 dB on this clip.
    The bench-scale gate (<=0.02 dB at 480p) is recorded in STATUS.md."""
    clean, noisy, zf = _clip()
    cfg = default_config(20.0, preset="iphone").stage(0)
    out_f = np.asarray(proc_nl(noisy, None, None, zf, zf, cfg))
    out_b = np.asarray(proc_nl(noisy, None, None, zf, zf,
                               cfg.replace(agg_bf16=True)))
    assert np.abs(out_f - out_b).max() > 0        # it does round something
    p_f = compute_psnr(out_f, clean)
    p_b = compute_psnr(out_b, clean)
    assert abs(p_f - p_b) <= 0.05, (p_f, p_b)
