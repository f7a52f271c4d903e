"""Letterbox resize for detect-time preprocessing.

Port of ``letterbox_transform`` / ``letterbox_host`` from
``yolojax/data/augment.py``. The resize is ``F.interpolate`` (bilinear,
``align_corners=False``, no antialias), which computes what
``cv2.resize(INTER_LINEAR)`` computes on float images; the port does not
need cv2. The training-time augmentation comes with the training slice.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


def letterbox_transform(
    w: int, h: int, dim: int, *, stretch: bool = False
) -> Tuple[float, float, float, float]:
    """The pure box transform of :func:`letterbox_host` for a (w, h) source:
    (scale_x, scale_y, pad_x, pad_y), normalized, with
    box_canvas = box_image * scale + pad.
    """
    if stretch:
        return (1.0, 1.0, 0.0, 0.0)
    r = min(dim / w, dim / h)
    nw, nh = int(round(w * r)), int(round(h * r))
    px, py = (dim - nw) // 2, (dim - nh) // 2
    return (nw / dim, nh / dim, px / dim, py / dim)


def _resize(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(H, W, C) float -> (size[0], size[1], C), bilinear, half-pixel."""
    out = F.interpolate(img.permute(2, 0, 1)[None], size=size,
                        mode="bilinear", align_corners=False, antialias=False)
    return out[0].permute(1, 2, 0)


def letterbox_host(
    img: Union[np.ndarray, torch.Tensor], dim: int, *, stretch: bool = False
) -> Tuple[torch.Tensor, Tuple[float, float, float, float]]:
    """Resize an HWC uint8/float RGB image to (dim, dim), aspect-preserving
    with 0.5-gray padding (or plain stretch).

    Returns (canvas float32 (dim, dim, 3) in [0, 1] on the image's device,
    (scale_x, scale_y, pad_x, pad_y)) where box_canvas = box_image * scale
    + pad, all normalized.
    """
    img = torch.as_tensor(img)
    h, w = img.shape[:2]
    img = img.float() / 255.0 if img.dtype == torch.uint8 else img.float()
    if stretch:
        return (_resize(img, (dim, dim)),
                letterbox_transform(w, h, dim, stretch=True))
    sx, sy, pxn, pyn = letterbox_transform(w, h, dim)
    nw, nh = int(round(sx * dim)), int(round(sy * dim))
    px, py = int(round(pxn * dim)), int(round(pyn * dim))
    canvas = torch.full((dim, dim, 3), 0.5, dtype=torch.float32,
                        device=img.device)
    canvas[py: py + nh, px: px + nw] = _resize(img, (nh, nw))
    return canvas, (sx, sy, pxn, pyn)
