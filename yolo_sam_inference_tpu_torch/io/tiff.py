"""Minimal self-contained TIFF codec (tiled + stripped, deflate + raw).

The reference depends on ``tifffile`` for zlib-compressed tiled TIFF output
(reference ``utils/image_utils.py:8-104``). That package is not available in
this environment, so we implement the small subset of TIFF 6.0 the framework
needs directly on numpy + zlib:

* write: grayscale (H, W) or RGB (H, W, 3), uint8/uint16, deflate-compressed
  tiles of a configurable size (default 256x256), optional ImageDescription
  metadata (JSON);
* read: the subset we write, plus raw (uncompressed) and stripped layouts so
  externally produced simple TIFFs load too. PIL remains the fallback reader
  for anything else (see ``images.py``).

Byte layout follows the TIFF 6.0 specification (little-endian "II" variant).
A copy of the JAX package's ``io/tiff.py``, which the port may not import:
the two write the same bytes and read each other's files.
"""

from __future__ import annotations

import json
import struct
import zlib

from .deflate import compress as _zlib_compress
from typing import Any, Dict, Optional, Tuple

import numpy as np

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_IMAGE_DESCRIPTION = 270
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_PREDICTOR = 317
_TILE_WIDTH = 322
_TILE_LENGTH = 323
_TILE_OFFSETS = 324
_TILE_BYTE_COUNTS = 325
_SAMPLE_FORMAT = 339

# TIFF field types
_T_SHORT = 3
_T_LONG = 4
_T_ASCII = 2

_COMPRESSION_NONE = 1
_COMPRESSION_DEFLATE_ADOBE = 8
_COMPRESSION_DEFLATE_OLD = 32946


def _tile_grid(h: int, w: int, th: int, tw: int) -> Tuple[int, int]:
    return (h + th - 1) // th, (w + tw - 1) // tw


def write_tiff(
    path,
    image: np.ndarray,
    *,
    compression: str = "zlib",
    compression_level: int = 6,
    tile: Optional[Tuple[int, int]] = (256, 256),
    metadata: Optional[Dict[str, Any]] = None,
) -> None:
    """Write ``image`` as a (optionally tiled, optionally deflate) TIFF."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3):
        raise ValueError(f"unsupported image shape {image.shape}")
    if img.dtype == np.bool_:
        img = img.astype(np.uint8) * 255
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"unsupported dtype {img.dtype}; normalize first")
    img = np.ascontiguousarray(img)
    h, w, spp = img.shape
    bps = img.dtype.itemsize * 8
    photometric = 2 if spp == 3 else 1
    comp_id = _COMPRESSION_DEFLATE_ADOBE if compression == "zlib" else _COMPRESSION_NONE

    # --- encode pixel data blocks -------------------------------------------------
    blocks = []
    if tile is not None:
        th, tw = tile
        # TIFF requires tile dims to be multiples of 16.
        th = max(16, (th // 16) * 16)
        tw = max(16, (tw // 16) * 16)
        ny, nx = _tile_grid(h, w, th, tw)
        for ty in range(ny):
            for tx in range(nx):
                block = np.zeros((th, tw, spp), dtype=img.dtype)
                ys, xs = ty * th, tx * tw
                sub = img[ys : ys + th, xs : xs + tw]
                block[: sub.shape[0], : sub.shape[1]] = sub
                raw = block.tobytes()
                blocks.append(
                    _zlib_compress(raw, compression_level) if comp_id != _COMPRESSION_NONE else raw
                )
    else:
        raw = img.tobytes()
        blocks.append(
            _zlib_compress(raw, compression_level) if comp_id != _COMPRESSION_NONE else raw
        )

    # --- assemble entries ----------------------------------------------------------
    desc = None
    if metadata is not None:
        desc = json.dumps(metadata).encode("ascii", "replace") + b"\x00"

    entries = []  # (tag, type, count, packed-value-or-None, extra-bytes-or-None)

    def add(tag, typ, count, value=None, extra=None):
        entries.append([tag, typ, count, value, extra])

    add(_IMAGE_WIDTH, _T_LONG, 1, w)
    add(_IMAGE_LENGTH, _T_LONG, 1, h)
    if spp == 1:
        add(_BITS_PER_SAMPLE, _T_SHORT, 1, bps)
    else:
        add(_BITS_PER_SAMPLE, _T_SHORT, 3, None, struct.pack("<3H", bps, bps, bps))
    add(_COMPRESSION, _T_SHORT, 1, comp_id)
    add(_PHOTOMETRIC, _T_SHORT, 1, photometric)
    if desc is not None:
        add(_IMAGE_DESCRIPTION, _T_ASCII, len(desc), None, desc)
    add(_SAMPLES_PER_PIXEL, _T_SHORT, 1, spp)
    add(_PLANAR_CONFIG, _T_SHORT, 1, 1)
    add(_SAMPLE_FORMAT, _T_SHORT, 1, 1)

    n_blocks = len(blocks)
    counts_bytes = struct.pack(f"<{n_blocks}I", *[len(b) for b in blocks])
    if tile is not None:
        add(_TILE_WIDTH, _T_LONG, 1, tw)
        add(_TILE_LENGTH, _T_LONG, 1, th)
        offsets_entry = [_TILE_OFFSETS, _T_LONG, n_blocks, None, None]
        entries.append(offsets_entry)
        add(_TILE_BYTE_COUNTS, _T_LONG, n_blocks, None, counts_bytes)
    else:
        add(_ROWS_PER_STRIP, _T_LONG, 1, h)
        offsets_entry = [_STRIP_OFFSETS, _T_LONG, n_blocks, None, None]
        entries.append(offsets_entry)
        add(_STRIP_BYTE_COUNTS, _T_LONG, n_blocks, None, counts_bytes)

    entries.sort(key=lambda e: e[0])

    # --- layout: header | IFD | extra data | pixel blocks ---------------------------
    header_size = 8
    ifd_size = 2 + 12 * len(entries) + 4
    extra_offset = header_size + ifd_size

    # first pass: place extra byte arrays
    extras = []
    cursor = extra_offset
    for e in entries:
        tag, typ, count, value, extra = e
        if extra is not None and len(extra) > 4:
            if cursor % 2:
                extras.append(b"\x00")
                cursor += 1
            e[3] = cursor  # offset
            extras.append(extra)
            cursor += len(extra)

    # place block offsets array (needs pixel data offsets, so reserve space)
    offsets_placeholder_pos = None
    if n_blocks * 4 > 4:
        if cursor % 2:
            extras.append(b"\x00")
            cursor += 1
        offsets_placeholder_pos = cursor
        offsets_entry[3] = cursor
        extras.append(b"\x00" * (n_blocks * 4))
        cursor += n_blocks * 4

    # pixel data
    block_offsets = []
    for b in blocks:
        if cursor % 2:
            extras.append(b"\x00")
            cursor += 1
        block_offsets.append(cursor)
        extras.append(b)
        cursor += len(b)

    if offsets_placeholder_pos is None:
        offsets_entry[3] = block_offsets[0]

    # --- serialize -------------------------------------------------------------------
    out = bytearray()
    out += struct.pack("<2sHI", b"II", 42, header_size)
    out += struct.pack("<H", len(entries))
    for tag, typ, count, value, extra in entries:
        out += struct.pack("<HHI", tag, typ, count)
        if extra is not None and len(extra) <= 4:
            out += extra.ljust(4, b"\x00")
        elif typ == _T_SHORT and extra is None:
            out += struct.pack("<HH", value, 0)
        else:
            out += struct.pack("<I", value)
    out += struct.pack("<I", 0)  # no next IFD

    for chunk in extras:
        out += chunk

    if offsets_placeholder_pos is not None:
        out[offsets_placeholder_pos : offsets_placeholder_pos + 4 * n_blocks] = struct.pack(
            f"<{n_blocks}I", *block_offsets
        )

    with open(path, "wb") as f:
        f.write(bytes(out))


def _read_ifd_entries(data: bytes, offset: int, fmt: str):
    (count,) = struct.unpack_from(f"{fmt}H", data, offset)
    entries = {}
    pos = offset + 2
    for _ in range(count):
        tag, typ, n = struct.unpack_from(f"{fmt}HHI", data, pos)
        raw = data[pos + 8 : pos + 12]
        if typ == _T_SHORT:
            size = 2 * n
        elif typ in (_T_LONG,):
            size = 4 * n
        elif typ == _T_ASCII:
            size = n
        else:
            size = 4 * n  # treat unknown as long-ish
        if size <= 4:
            payload = raw[:size]
        else:
            (off,) = struct.unpack(f"{fmt}I", raw)
            payload = data[off : off + size]
        if typ == _T_SHORT:
            values = struct.unpack(f"{fmt}{n}H", payload)
        elif typ == _T_LONG:
            values = struct.unpack(f"{fmt}{n}I", payload)
        elif typ == _T_ASCII:
            values = (payload.rstrip(b"\x00").decode("ascii", "replace"),)
        else:
            values = (payload,)
        entries[tag] = values
        pos += 12
    return entries


def read_tiff(path, *, return_metadata: bool = False):
    """Read a TIFF written by :func:`write_tiff` (plus simple external TIFFs)."""
    with open(path, "rb") as f:
        return decode_tiff(f.read(), return_metadata=return_metadata)


def decode_tiff(data: bytes, *, return_metadata: bool = False):
    """:func:`read_tiff` of TIFF bytes already in memory (a request body)."""
    byte_order = data[:2]
    if byte_order == b"II":
        fmt = "<"
    elif byte_order == b"MM":
        fmt = ">"
    else:
        raise ValueError("not a TIFF file")
    (magic, ifd_off) = struct.unpack_from(f"{fmt}HI", data, 2)
    if magic != 42:
        raise ValueError("not a classic TIFF file")
    tags = _read_ifd_entries(data, ifd_off, fmt)

    w = tags[_IMAGE_WIDTH][0]
    h = tags[_IMAGE_LENGTH][0]
    spp = tags.get(_SAMPLES_PER_PIXEL, (1,))[0]
    bps = tags.get(_BITS_PER_SAMPLE, (8,))[0]
    comp = tags.get(_COMPRESSION, (1,))[0]
    dtype = np.dtype(f"{fmt}u{bps // 8}")
    if comp not in (_COMPRESSION_NONE, _COMPRESSION_DEFLATE_ADOBE, _COMPRESSION_DEFLATE_OLD):
        raise ValueError(f"unsupported TIFF compression {comp}")

    def decode(buf: bytes) -> bytes:
        return zlib.decompress(buf) if comp != _COMPRESSION_NONE else buf

    img = np.zeros((h, w, spp), dtype=dtype)
    if _TILE_OFFSETS in tags:
        tw = tags[_TILE_WIDTH][0]
        th = tags[_TILE_LENGTH][0]
        ny, nx = _tile_grid(h, w, th, tw)
        offsets = tags[_TILE_OFFSETS]
        counts = tags[_TILE_BYTE_COUNTS]
        for i, (off, cnt) in enumerate(zip(offsets, counts)):
            ty, tx = divmod(i, nx)
            block = np.frombuffer(decode(data[off : off + cnt]), dtype=dtype)
            block = block.reshape(th, tw, spp)
            ys, xs = ty * th, tx * tw
            ye, xe = min(ys + th, h), min(xs + tw, w)
            img[ys:ye, xs:xe] = block[: ye - ys, : xe - xs]
    else:
        offsets = tags[_STRIP_OFFSETS]
        counts = tags[_STRIP_BYTE_COUNTS]
        rps = tags.get(_ROWS_PER_STRIP, (h,))[0]
        row = 0
        for off, cnt in zip(offsets, counts):
            block = np.frombuffer(decode(data[off : off + cnt]), dtype=dtype)
            nrows = min(rps, h - row)
            block = block[: nrows * w * spp].reshape(nrows, w, spp)
            img[row : row + nrows] = block
            row += nrows

    if spp == 1:
        img = img[..., 0]
    if fmt == ">":
        img = img.astype(img.dtype.newbyteorder("="))

    if return_metadata:
        meta = None
        if _IMAGE_DESCRIPTION in tags:
            try:
                meta = json.loads(tags[_IMAGE_DESCRIPTION][0])
            except (json.JSONDecodeError, TypeError):
                meta = {"raw_description": tags[_IMAGE_DESCRIPTION][0]}
        return img, meta
    return img
