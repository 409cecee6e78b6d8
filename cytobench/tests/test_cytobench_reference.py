"""The plain reference against the port's plain path (the CPU takes every
kernel's plain version), both in fp32 at the tiny configuration on the same
weights and frames: the same detections, masks and metrics."""

import numpy as np
import torch

from cytobench import traffic as gen
from cytobench.reference import pipeline as rpipe
from cytobench.run import build_pipeline
from cytobench.weights import weights

from . import tiny


def test_reference_is_the_ports_plain_path():
    cfg, traffic = tiny.tiny_config("float32"), tiny.tiny_traffic()
    frames = gen.frame_pool(5, traffic)[0]
    pipe = build_pipeline(cfg, traffic, 5, "cpu")
    got = pipe.process_batch_arrays(frames)
    with torch.inference_mode():
        want = rpipe.pipeline(weights(cfg, 5, "cpu", host=False), torch.from_numpy(frames), cfg,
                              traffic)
    assert np.array_equal(got["valid"], want["valid"].numpy()) and got["valid"].any()
    np.testing.assert_allclose(got["boxes"], want["boxes"].numpy(), atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"].numpy(), atol=1e-5)
    np.testing.assert_array_equal(got["offsets"], want["offsets"].numpy())
    masks = want["mask_crops"].numpy()
    assert (got["mask_crops"] != masks).mean() < 1e-4 and masks.any()
    for key, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][key], v.numpy(), rtol=1e-5, atol=1e-4,
                                   err_msg=key)


def test_weights_repeat_from_the_seed():
    cfg = tiny.tiny_config()
    a = weights(cfg, 7, "cpu", host=True)
    b = weights(cfg, 7, "cpu", host=True)
    c = weights(cfg, 8, "cpu", host=True)
    pa, pb, pc = (t[1]["vision"]["layers"][0]["mlp1"]["w"] for t in (a, b, c))
    assert np.array_equal(pa, pb) and not np.array_equal(pa, pc)
    # every value is a bfloat16, so the program's cast to bf16 changes none
    assert np.array_equal(torch.from_numpy(pa).bfloat16().float().numpy(), pa)
