"""SAM configuration (static hyperparameters; everything shape-relevant)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SamTPUConfig:
    """Static SAM hyperparameters (one config object for all three stages)."""

    # vision encoder (ViTDet-style)
    image_size: int = 1024
    patch_size: int = 16
    vision_hidden: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    vision_mlp_dim: int = 3072
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    output_channels: int = 256  # neck output / decoder input
    use_rel_pos: bool = True
    # prompt encoder / decoder
    prompt_hidden: int = 256
    num_pos_feats: int = 128
    mask_input_channels: int = 16
    decoder_layers: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    iou_head_hidden: int = 256
    iou_head_depth: int = 3
    num_multimask_outputs: int = 3
    layer_norm_eps: float = 1e-6
    decoder_layer_norm_eps: float = 1e-6

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size  # 64 for standard SAM

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1

    @property
    def low_res_size(self) -> int:
        return self.grid_size * 4  # 256 for standard SAM


def sam_vit_b(image_size: int = 1024) -> SamTPUConfig:
    return SamTPUConfig(image_size=image_size)


def sam_vit_l(image_size: int = 1024) -> SamTPUConfig:
    return SamTPUConfig(
        image_size=image_size,
        vision_hidden=1024,
        vision_layers=24,
        vision_heads=16,
        vision_mlp_dim=4096,
        global_attn_indexes=(5, 11, 17, 23),
    )


def sam_vit_h(image_size: int = 1024) -> SamTPUConfig:
    return SamTPUConfig(
        image_size=image_size,
        vision_hidden=1280,
        vision_layers=32,
        vision_heads=16,
        vision_mlp_dim=5120,
        global_attn_indexes=(7, 15, 23, 31),
    )


def sam_tiny_test() -> SamTPUConfig:
    """Tiny config for parity tests against a random-init torch SamModel."""
    return SamTPUConfig(
        image_size=64,
        patch_size=8,
        vision_hidden=32,
        vision_layers=2,
        vision_heads=2,
        vision_mlp_dim=64,
        window_size=2,
        global_attn_indexes=(1,),
        output_channels=16,
        prompt_hidden=16,
        num_pos_feats=8,  # must equal prompt_hidden // 2
        mask_input_channels=4,
        decoder_layers=2,
        decoder_heads=2,
        decoder_mlp_dim=32,
        iou_head_hidden=16,
    )
