"""Per-class detection drawing (cv2 BGR images).

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
