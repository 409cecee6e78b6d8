"""The plain fp32 reference of the benchmarked pipeline.

Plain PyTorch on any device, TF32 off: YOLOv8 with its DFL decode and greedy
NMS (``yolo.py``), SAM's ViT encoder, box prompt encoder, two-way decoder and
mask head with the crop resampling (``sam.py``), and the 16 morphometrics
with the hull from 256 support directions (``metrics.py``). It reads the
weight tree that the benchmark makes (``cytobench/weights.py``) and the
frames of the traffic; it imports nothing of the program under test.
"""

import torch


def fp32_exact() -> None:
    """Keep fp32 products in fp32 on the card: no TF32 in matmuls or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
