"""Image writing: PNG and PPM (standard library only), raw .npy.

The reference never saves images at all (SURVEY.md §5 checkpoint/resume:
none) — its output lives only in the window framebuffer. Here saving is a
first-class capability, and .npy dumps double as checkpoint/resume state for
progressive renders.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def save_image(img: np.ndarray, path: str):
    """img: uint8 [H,W,3] (or float in [0,1], converted)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.99, 0, 255).astype(np.uint8)
    if path.endswith(".ppm"):
        _save_ppm(img, path)
    elif path.endswith(".npy"):
        np.save(path, img)
    else:
        with open(path, "wb") as f:
            f.write(encode_png(img))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H,W,3] (RGB) or [H,W,4] (RGBA) -> PNG file bytes: 8-bit
    truecolor, one zlib stream, filter type 0 on every scanline."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    if c not in (3, 4):
        raise ValueError(f"PNG needs 3 or 4 channels, got {c}")
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def _save_ppm(img: np.ndarray, path: str):
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img[..., :3].tobytes())


def load_npy_state(path: str):
    return np.load(path)
