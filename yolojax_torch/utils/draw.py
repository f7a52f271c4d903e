"""Per-class detection drawing (cv2 BGR images), and a box outline and a
PNG writer that need no cv2 (the training summaries use them).

Copy of ``yolojax/utils/draw.py``: a deterministic golden-angle hue walk
gives well-separated, stable colors for any class count.
"""

from __future__ import annotations

import colorsys
from typing import Tuple


def class_color(idx: int) -> Tuple[int, int, int]:
    """Stable BGR color for a class index (golden-angle hue spacing)."""
    hue = (idx * 0.61803398875) % 1.0
    r, g, b = colorsys.hsv_to_rgb(hue, 0.85, 1.0)
    return (int(b * 255), int(g * 255), int(r * 255))


def draw_detection(img, x0: int, y0: int, x1: int, y1: int,
                   label: str, cls: int, *, thickness: int = 2,
                   rgb: bool = False) -> None:
    """Draw one labeled box in-place on a uint8 image (BGR unless rgb=)."""
    import cv2

    color = class_color(cls)
    if rgb:
        color = color[::-1]
    cv2.rectangle(img, (x0, y0), (x1, y1), color, thickness)
    cv2.putText(img, label, (x0, max(y0 - 4, 10)),
                cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)


def draw_rectangle(img, x0: int, y0: int, x1: int, y1: int,
                   color: Tuple[int, int, int], thickness: int = 1) -> None:
    """Draw a box outline in place on an (H, W, 3) uint8 numpy image,
    clipped to the frame, without cv2."""
    h, w = img.shape[:2]
    x0, x1 = sorted((int(x0), int(x1)))
    y0, y1 = sorted((int(y0), int(y1)))
    for t in range(thickness):
        for y in (y0 + t, y1 - t):
            if 0 <= y < h:
                img[y, max(x0, 0):min(x1 + 1, w)] = color
        for x in (x0 + t, x1 - t):
            if 0 <= x < w:
                img[max(y0, 0):min(y1 + 1, h), x] = color


def write_png(path: str, rgb) -> None:
    """Write an (H, W, 3) uint8 RGB numpy image as an 8-bit PNG, with zlib
    only (no cv2 or PIL)."""
    import struct
    import zlib

    import numpy as np

    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))
