"""A minimal PNG writer (8-bit RGB, zlib + struct, no PIL).

The experiment scripts write their PNGs through it, as the JAX package's
scripts do through PIL (`experiments/gtruth.py` `_save_png`,
`experiments/reproject.py`): the machine that runs the port may have no
PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path: str, img) -> str:
    """Write an (H, W, 3) float image in [0, 1] (clipped) as an 8-bit RGB
    PNG, quantized as the JAX scripts do: (clip(img, 0, 1) * 255) cast to
    uint8."""
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"want an (H, W, 3) image, got {img.shape}")
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    h, w, _ = u8.shape
    # each scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), u8.reshape(h, w * 3)],
                         axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
    return path
