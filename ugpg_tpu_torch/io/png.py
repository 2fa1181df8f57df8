"""A PNG writer of the port's own, with ``struct`` and ``zlib`` only.

Writes 8-bit gray (an (H, W) array, color type 0) or 8-bit RGB (an
(H, W, 3) array, color type 2), non-interlaced, every row with filter 0 in
one zlib IDAT chunk: the inferer's ``*_mask.png`` and ``*_vis.png`` and the
evaluation CLI's ``uncertainty_{idx}.png``, which the JAX package writes
with PIL.  The port's decoders read them back
(``native.decode_png_gray``, ``native.decode_png``).
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path

import numpy as np

__all__ = ["png_bytes", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(image: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3) uint8 -> the bytes of a PNG file."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise TypeError(f"png_bytes: uint8 expected, got {image.dtype}")
    if image.ndim == 2:
        color_type = 0
    elif image.ndim == 3 and image.shape[2] == 3:
        color_type = 2
    else:
        raise ValueError(f"png_bytes: (H, W) gray or (H, W, 3) RGB expected, got {image.shape}")
    h, w = image.shape[:2]
    if h == 0 or w == 0:
        raise ValueError("png_bytes: an image needs at least one pixel")
    rows = np.ascontiguousarray(image).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def write_png(path: str | os.PathLike, image: np.ndarray) -> Path:
    """Write ``image`` (see ``png_bytes``) as the PNG file ``path``."""
    path = Path(path)
    path.write_bytes(png_bytes(image))
    return path
