"""Every SAM family on the engine's one path, on the CPU: the ViT
(``sam_tiny_test()``), MobileSAM (TinyViT at a 64-pixel canvas) and SAM 2
(``sam2_tiny_test()``), each with YOLOv8n at a 64-pixel letterbox on two
64x64 frames, fp32. The synchronised path and the batch stream give the same
outputs, SAM 2 alone hands on its chosen tokens, and the synchronised path
times the four stages and the model's own spans."""

import dataclasses

import numpy as np
import pytest
import torch

from synth import make_cell_image
from yolo_sam_inference_tpu_torch.models.sam import (
    HieraImageEncoder,
    SamImageEncoder,
    TinyViT,
    sam2_tiny_test,
    sam_tiny_test,
)
from yolo_sam_inference_tpu_torch.models.yolo import YoloConfig
from yolo_sam_inference_tpu_torch.pipeline import engine as tengine

torch.set_num_threads(2)

OPTS = dict(batch_size=2, yolo_size=64, max_det=4, metric_crop=24, nms_candidates=64)
STAGE_KEYS = {"yolo_detection", "sam_preprocess", "sam_inference_total", "metrics_total"}
FAMILIES = {
    # family: (pipeline arguments, encoder canvas, encoder class, the model's own spans)
    "vit": (dict(sam_config=sam_tiny_test()), None, SamImageEncoder, set()),
    "mobile-sam": (dict(sam_model_type="mobile-sam", sam_config=dataclasses.replace(
        sam_tiny_test(), image_size=64, patch_size=16)), 64, TinyViT, set()),
    "sam2": (dict(sam_config=sam2_tiny_test()), None, HieraImageEncoder,
             {"hiera_fine", "hiera_coarse", "sam2_head"}),
}


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(4)
    return np.stack([make_cell_image(rng, 64, 64) for _ in range(2)])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_runs_the_one_path(frames, family):
    kw, size, encoder, own = FAMILIES[family]
    pipe = tengine.CellSegmentationPipeline(
        device="cpu", yolo_config=YoloConfig(num_classes=1), seed=0,
        options=tengine.PipelineOptions(compute_dtype=torch.float32, sam_encoder_size=size,
                                        **OPTS), **kw)
    st = pipe._stages(64, 64)
    assert isinstance(st["sam"].vision, encoder)
    with torch.inference_mode():
        img = torch.as_tensor(frames)
        boxes, _, valid = st["detect"](img)
        segmented = st["segment"](st["embed"](img), boxes, valid)
    assert len(segmented) == (3 if family == "sam2" else 2)
    timings = {}
    synced = pipe.process_batch_arrays(frames, timings)
    streamed = pipe._fetch_outputs(pipe._dispatch_batch(frames))
    assert set(timings) == STAGE_KEYS | own
    assert synced["valid"].any()
    for key in ("boxes", "scores", "valid", "mask_crops", "offsets"):
        assert np.array_equal(synced[key], streamed[key]), key
    assert synced["metrics"].keys() == streamed["metrics"].keys()
    for key, v in synced["metrics"].items():
        assert np.array_equal(v, streamed["metrics"][key]), key
    assert "mask_token" not in synced["metrics"]
    if family == "sam2":
        token = synced["mask_token"]
        assert token.dtype == np.int32 and np.array_equal(token, streamed["mask_token"])
        assert np.array_equal(token < 0, ~synced["valid"])
    else:
        assert "mask_token" not in synced and "mask_token" not in streamed
