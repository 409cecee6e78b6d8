"""SAM in PyTorch: the ViT and TinyViT encoders, the prompt encoder and the
mask decoder (``model.py``, ``tinyvit.py``), the configs and the checkpoint
converters.

The JAX package's functions are methods here: ``sam_image_encoder`` is
``SamModel.vision``, ``sam_prompt_boxes`` / ``sam_prompt_points`` are
``SamPromptEncoder.boxes`` / ``.points``, ``sam_mask_decoder`` (multimask
output, dense prompts) is ``SamModel.mask_decoder`` and
``sam_forward_boxes`` is ``SamModel.forward_boxes``. SAM 2's image path
(the Hiera encoder, no JAX counterpart) is ``hiera.py``. A configuration's
class is its family (``config.py``).
"""

from .config import (
    Sam2Config,
    SamTPUConfig,
    mobile_sam,
    sam2_1_hiera_l,
    sam2_tiny_test,
    sam_tiny_test,
    sam_vit_b,
    sam_vit_h,
    sam_vit_l,
)
from .convert import (
    adapt_resolution,
    convert_hf_sam_state_dict,
    convert_mobilesam_state_dict,
    convert_mobilesam_tinyvit,
    is_mobilesam_state_dict,
    load_sam_params,
)
from .hiera import HieraImageEncoder, Sam2Model, init_sam2_params
from .model import SamImageEncoder, SamMaskDecoder, SamModel, SamPromptEncoder, init_sam_params
from .tinyvit import TinyViT, TinyViTConfig, init_tinyvit_params, is_tinyvit

__all__ = [
    "HieraImageEncoder", "Sam2Config", "Sam2Model", "init_sam2_params", "sam2_1_hiera_l",
    "sam2_tiny_test", "SamImageEncoder", "SamMaskDecoder", "SamModel", "SamPromptEncoder", "SamTPUConfig",
    "TinyViT", "TinyViTConfig", "adapt_resolution", "convert_hf_sam_state_dict",
    "convert_mobilesam_state_dict", "convert_mobilesam_tinyvit", "init_sam_params",
    "init_tinyvit_params", "is_mobilesam_state_dict", "is_tinyvit", "load_sam_params", "mobile_sam",
    "sam_tiny_test", "sam_vit_b", "sam_vit_h", "sam_vit_l",
]
