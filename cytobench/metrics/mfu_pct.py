"""The whole step's share of the card's bf16 peak, in %: the window's
frames times the model operations a frame (YOLOv8, the SAM encoder and
neck, max_det prompts through the decoder and the mask head;
``cytobench/flops.py``) over the window's seconds times 989 TFLOP/s."""

from cytobench.flops import PEAK, model_flops_per_image


def read(rec):
    w = rec["window"]
    if w["seconds"] <= 0:
        return None
    ops = w["images"] * model_flops_per_image(rec["config"], rec["traffic"])
    return 100.0 * ops / (w["seconds"] * PEAK["bf16"])
