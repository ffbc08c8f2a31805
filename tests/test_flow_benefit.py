"""Flow-aware search beats zero flow on a large-motion clip.

The reference obtains flows from external C++ TV-L1
(/root/reference/tests/test_gpu_sim_search.py:128 svnlb.swig.runPyFlow) and
passes them to the flow-offset-aware search [N1].  This repo's in-house
estimators (ops/flow: TV-L1 default + pyramidal LK) must show measured
evidence that they actually help: on a ~4 px/frame drift clip the temporal
search window loses real matches without flow tracking, and estimated
flows must recover a measurable PSNR gain in BOTH passes.

Measured at the pinned settings (CPU, 2026-08-18): zero-flow basic/deno
28.52/29.81 dB; TV-L1 flows 28.99/30.31 (+0.48/+0.50); LK flows
28.95/30.28 (+0.43/+0.47) on frame-drift motion of mean |v| ~ 3-4 px.

Second motion magnitude (measured on the CPU): at
~8 px/frame drift (96x96, mean estimated |v| ~ 6.1 px) zero-flow
basic/deno 28.26/29.29 dB; estimated flows 29.11/30.46 (+0.85/+1.17) —
the benefit GROWS with motion, as it must.
"""

import pytest


import numpy as np

from vnlb_tpu.api import denoise
from vnlb_tpu.config import default_config
from vnlb_tpu.ops.flow import estimate_flows
from vnlb_tpu.testing.data import add_noise, synthetic_video
from vnlb_tpu.utils.metrics import compute_psnr


@pytest.mark.parametrize("motion,size,min_gain", [
    (4.0, 72, 0.08),
    (8.0, 96, 0.5),      # large-motion case: measured +0.85/+1.17
])
def test_flow_aware_beats_zero_flow(motion, size, min_gain):
    sigma = 20.0
    clean = synthetic_video(5, size, size, seed=11, motion=motion)
    noisy = add_noise(clean, sigma, seed=12)
    # small spatial window + long temporal reach: without flow offsets the
    # drifted content leaves the +-half window after ~2 frames
    cfg = default_config(sigma, preset="iphone",
                         npatches=[40, 30], bsize=[128, 128])

    flows = estimate_flows(noisy)
    fwd = np.asarray(flows[0])
    assert np.abs(fwd).mean() > 1.0          # LK actually tracked the drift

    d0, b0, _ = denoise(noisy, sigma, cfg=cfg)
    d1, b1, _ = denoise(noisy, sigma, flows=flows, cfg=cfg)

    p = lambda x: compute_psnr(np.asarray(x), clean)
    pb0, pd0, pb1, pd1 = p(b0), p(d0), p(b1), p(d1)
    assert pb1 > pb0 + min_gain, (pb0, pb1)
    assert pd1 > pd0 + min_gain, (pd0, pd1)
