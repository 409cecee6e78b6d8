"""PNG without PIL: the writer, and the reader of the forms with alpha.

* :func:`png_bytes` writes an 8-bit PNG of a uint8 array (gray, gray +
  alpha, RGB or RGBA), every scanline filtered with one filter type.
* :func:`decode_png_alpha` reads the 8-bit, non-interlaced gray + alpha and
  RGBA forms (IHDR colour types 4 and 6) with their alpha plane: (H, W, 2)
  or (H, W, 4), the layout ``np.asarray(PIL.Image.open(...))`` gives. The
  native decoder (``png_native.py``) drops alpha, which would hide a
  translucent frame from the service's channel policy (``web/serve.py``).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOUR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> IHDR colour type
_ALPHA_CHANNELS = {4: 2, 6: 4}  # IHDR colour type with alpha -> channels


def _png_filter(rows: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """PNG scanline filter ``kind`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)
    of uint8 rows (H, W * bpp): the filtered bytes, each predicted from the
    unfiltered neighbours a (left), b (up), c (up-left), zero off the edge."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    if kind == 0:
        pred = np.zeros_like(x)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) // 2
    elif kind == 4:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"PNG filter type {kind} is not one of 0-4")
    return ((x - pred) % 256).astype(np.uint8)


def png_bytes(image, filter_type: int = 0, level: int = 6) -> bytes:
    """An 8-bit PNG of uint8 ``image``, (H, W) gray or (H, W, 2 | 3 | 4) gray +
    alpha, RGB or RGBA, not interlaced, every scanline filtered with
    ``filter_type`` (0-4), compressed with zlib."""
    img = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = _png_filter(img.reshape(h, w * ch), ch, filter_type)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPES[ch], 0, 0, 0)
    return (PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + chunk(b"IEND", b""))


def _ihdr(data: bytes) -> Optional[tuple]:
    """(width, height, bit depth, colour type, interlace) of PNG bytes, None
    where they do not start with a PNG signature and an IHDR chunk."""
    if len(data) < 33 or not data.startswith(PNG_SIGNATURE) or data[12:16] != b"IHDR":
        return None
    w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB", data[16:29])
    return w, h, depth, colour, interlace


def has_alpha_form(data: bytes) -> bool:
    """True for PNG bytes that :func:`decode_png_alpha` reads: 8-bit, not
    interlaced, gray + alpha or RGBA."""
    hdr = _ihdr(data)
    return hdr is not None and hdr[2] == 8 and hdr[3] in _ALPHA_CHANNELS and hdr[4] == 0


def _unfilter_row(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline's bytes from its filtered bytes and the row above."""
    if kind == 0:
        return line
    if kind == 1:  # Sub: a running sum of each channel along the row
        return (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0) & 255) \
            .astype(np.uint8).reshape(-1)
    if kind == 2:
        return ((line.astype(np.int16) + prev) & 255).astype(np.uint8)
    if kind not in (3, 4):
        raise ValueError(f"PNG filter type {kind} is not one of 0-4")
    # Average and Paeth predict from the byte just decoded: one byte at a time
    cur = bytearray(len(line))
    up = prev.tolist()
    for i, v in enumerate(line.tolist()):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (v + pred) & 255
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png_alpha(data: bytes) -> np.ndarray:
    """uint8 (H, W, 2) or (H, W, 4) of an 8-bit, non-interlaced gray + alpha
    or RGBA PNG: the IDAT chunks inflated and unfiltered, alpha kept.
    Raises ValueError for any other form or for corrupt bytes."""
    if not has_alpha_form(data):
        raise ValueError("not an 8-bit, non-interlaced gray + alpha or RGBA PNG")
    w, h, _, colour, _ = _ihdr(data)
    bpp = _ALPHA_CHANNELS[colour]
    idat, pos = [], 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        if tag == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        elif tag == b"IEND":
            break
        pos += 12 + length
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from e
    stride = w * bpp
    if raw.size < h * (stride + 1):
        raise ValueError(f"PNG image data holds {raw.size} bytes, {h * (stride + 1)} expected")
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
    return out.reshape(h, w, bpp)
