from .config import SamTPUConfig, sam_tiny_test, sam_vit_b, sam_vit_h, sam_vit_l
from .convert import adapt_resolution
from .model import SamImageEncoder, SamMaskDecoder, SamModel, SamPromptEncoder, init_sam_params

__all__ = [
    "SamImageEncoder", "SamMaskDecoder", "SamModel", "SamPromptEncoder", "SamTPUConfig",
    "adapt_resolution", "init_sam_params", "sam_tiny_test", "sam_vit_b", "sam_vit_h", "sam_vit_l",
]
