from .config import SamTPUConfig, sam_tiny_test, sam_vit_b, sam_vit_h, sam_vit_l
from .convert import (
    adapt_resolution,
    convert_hf_sam_state_dict,
    convert_mobilesam_state_dict,
    convert_mobilesam_tinyvit,
    is_mobilesam_state_dict,
    load_sam_params,
)
from .model import SamImageEncoder, SamMaskDecoder, SamModel, SamPromptEncoder, init_sam_params
from .tinyvit import TinyViT, TinyViTConfig, init_tinyvit_params, is_tinyvit

__all__ = [
    "SamImageEncoder", "SamMaskDecoder", "SamModel", "SamPromptEncoder", "SamTPUConfig",
    "TinyViT", "TinyViTConfig", "adapt_resolution", "convert_hf_sam_state_dict",
    "convert_mobilesam_state_dict", "convert_mobilesam_tinyvit", "init_sam_params",
    "init_tinyvit_params", "is_mobilesam_state_dict", "is_tinyvit", "load_sam_params",
    "sam_tiny_test", "sam_vit_b", "sam_vit_h", "sam_vit_l",
]
