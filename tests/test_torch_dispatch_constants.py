"""The batch stream builds no tensor from host data after its first batch.

Every constant a stage needs (the letterbox's shift and limits, the resize
matrices, SAM's mean and std, the metrics' fill values and hull directions,
the bitpack's weights) is made on the device once (``ops/constants.py``) and
reused, so on a card the dispatch makes no blocking host-to-device copy. On
the CPU: the calls that build a tensor from host data inside ``fused_call``
and ``_start_fetch`` are counted on a second batch (the frames' upload in
``_images_to_device`` is a true copy and is not counted); the outputs are the
same bits with the caches warm and cleared; the cached constants serve
autograd after an inference-mode call. A tiny fp32 pipeline
(``sam_tiny_test()`` at its 64 canvas, YOLOv8n at a 64-pixel letterbox):
64x64 frames need no resize, 80x96 frames take the letterbox's and SAM's.
"""

import numpy as np
import pytest
import torch

from synth import make_cell_image
from yolo_sam_inference_tpu_torch.models.sam import sam_tiny_test
from yolo_sam_inference_tpu_torch.models.yolo import YoloConfig
from yolo_sam_inference_tpu_torch.ops import constants, metrics, preprocess
from yolo_sam_inference_tpu_torch.ops import tinyvit_attention
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

torch.set_num_threads(1)

OPTS = dict(batch_size=2, yolo_size=64, sam_encoder_size=64, max_det=4, metric_crop=48,
            nms_candidates=64)
SHAPES = [(64, 64), (80, 96)]
HOST_BUILDERS = ("tensor", "as_tensor", "from_numpy")
CACHES = (constants.constant, preprocess._linear_weights_on, metrics._hull_directions_on,
          tinyvit_attention._offset_index_on)


def _clear_caches():
    for cache in CACHES:
        cache.cache_clear()


def _pipeline():
    return tengine.CellSegmentationPipeline(
        device="cpu", sam_config=sam_tiny_test(), yolo_config=YoloConfig(num_classes=1), seed=0,
        options=tengine.PipelineOptions(compute_dtype=torch.float32, **OPTS))


@pytest.fixture(scope="module")
def pipe():
    return _pipeline()


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    return np.stack([make_cell_image(rng, *shape) for _ in range(2)])


def _batch(pipe, frames):
    return pipe._fetch_outputs(pipe._dispatch_batch(frames, fetch_masks=True))


def _flat(out):
    flat = {k: v for k, v in out.items() if k != "metrics"}
    flat.update({"metrics." + k: v for k, v in out["metrics"].items()})
    return flat


@pytest.fixture
def host_builds(pipe, monkeypatch):
    """The names of the host-data tensor builders called inside
    ``fused_call`` and ``_start_fetch``, in order."""
    calls, depth = [], [0]
    for name in HOST_BUILDERS:
        def counted(*a, _real=getattr(torch, name), _name=name, **k):
            if depth[0]:
                calls.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(torch, name, counted)
    for meth in ("fused_call", "_start_fetch"):
        def inside(*a, _real=getattr(pipe, meth), **k):
            depth[0] += 1
            try:
                return _real(*a, **k)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(pipe, meth, inside)
    return calls


@pytest.mark.parametrize("shape", SHAPES)
def test_second_batch_builds_no_tensor_from_host_data(pipe, host_builds, shape):
    frames = _frames(shape, 1)
    _clear_caches()
    _batch(pipe, frames)
    cold = list(host_builds)
    # the counter sees the constants made on the first batch: the letterbox's
    # shift and limits, SAM's mean and std, the hull directions, the bitpack
    assert cold.count("tensor") >= 5 and "from_numpy" in cold, cold
    if shape != (64, 64):  # the letterbox's two resize matrices, which SAM's resize shares
        assert cold.count("from_numpy") >= 3, cold
    host_builds.clear()
    _batch(pipe, _frames(shape, 2))
    assert host_builds == []


@pytest.mark.parametrize("shape", SHAPES)
def test_outputs_bit_equal_with_the_caches_warm_and_cleared(pipe, shape):
    frames = _frames(shape, 3)
    _batch(pipe, frames)
    warm = _flat(_batch(pipe, frames))
    _clear_caches()
    cold = _flat(_batch(pipe, frames))
    assert warm.keys() == cold.keys()
    assert warm["valid"].any()
    for k in warm:
        assert warm[k].dtype == cold[k].dtype and warm[k].shape == cold[k].shape, k
        assert np.array_equal(warm[k], cold[k]), k


def test_cached_constants_serve_autograd_after_inference_mode():
    """Constants first made inside ``torch.inference_mode()`` are ordinary
    tensors: autograd saves them (the resize matrices, SAM's std, the
    letterbox's limits) for a backward pass outside it. The stages are built
    outside inference mode, so that their weights are ordinary tensors too."""
    frames = _frames((80, 96), 4)[..., 0]
    st = _pipeline()._stages(80, 96)
    _clear_caches()
    with torch.inference_mode():
        u8 = torch.from_numpy(frames)
        preprocess.sam_preprocess_batch(tengine._ensure_rgb(u8), 64)
        st["detect"](u8)
    x = torch.tensor(frames, dtype=torch.float32, requires_grad=True)
    pix, _, _ = preprocess.sam_preprocess_batch(tengine._ensure_rgb(x), 64)
    boxes, scores, _ = st["detect"](x)
    (pix.sum() + boxes.sum() + scores.sum()).backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert x.grad.abs().sum() > 0
