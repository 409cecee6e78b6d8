"""Binary mask codec for JSONB / manifest storage.

Copy of ``yolo_sam_inference_tpu/utils/mask_encoding.py`` (the port may not
import the JAX package). Bit-compatible with the reference codec (reference ``utils/mask_encoding.py:10-65``):
``packbits -> zlib -> base64`` with the original shape carried alongside, so
masks written by either framework decode in the other (and in the Postgres
result viewer).
"""

from typing import Any, Dict

import base64
import zlib

import numpy as np


def encode_binary_mask(mask: np.ndarray) -> Dict[str, Any]:
    """Encode a binary mask for efficient JSON-compatible storage."""
    binary_mask = np.asarray(mask).astype(bool)
    compressed = zlib.compress(np.packbits(binary_mask))
    return {
        "encoding_type": "compressed_binary",
        "shape": tuple(int(s) for s in binary_mask.shape),
        "data": base64.b64encode(compressed).decode("ascii"),
    }


def decode_binary_mask(encoded: Dict[str, Any]) -> np.ndarray:
    """Inverse of :func:`encode_binary_mask`."""
    if encoded.get("encoding_type") != "compressed_binary":
        raise ValueError(f"Unsupported encoding type: {encoded.get('encoding_type')}")
    shape = tuple(encoded["shape"])
    raw = zlib.decompress(base64.b64decode(encoded["data"]))
    bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8))
    total = int(np.prod(shape))
    return bits[:total].reshape(shape).astype(bool)
