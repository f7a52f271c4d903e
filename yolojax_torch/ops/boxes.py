"""Box geometry + YOLO head decode (port of ``yolojax/ops/boxes.py``).

Coordinate convention: normalized image coordinates in [0, 1]; corner
boxes are (ymin, xmin, ymax, xmax). Every function broadcasts over leading
batch dims. The IoU expression keeps yolojax's operation order, which the
NMS kernel (``csrc/nms_greedy.cu``) repeats so that keep masks agree bit
for bit.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch


def xywh_to_corners(xy: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """(cx, cy), (w, h) -> (ymin, xmin, ymax, xmax), stacked on last axis."""
    half = wh * 0.5
    return torch.stack(
        [
            xy[..., 1] - half[..., 1],
            xy[..., 0] - half[..., 0],
            xy[..., 1] + half[..., 1],
            xy[..., 0] + half[..., 0],
        ],
        dim=-1,
    )


def _area(b: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(b[..., 2] - b[..., 0], min=0)
            * torch.clamp(b[..., 3] - b[..., 1], min=0))


def iou_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of corner boxes, broadcasting over leading dims. (..., 4) -> (...)."""
    lo = torch.maximum(a[..., :2], b[..., :2])
    hi = torch.minimum(a[..., 2:], b[..., 2:])
    hw = torch.clamp(hi - lo, min=0)
    inter = hw[..., 0] * hw[..., 1]
    union = _area(a) + _area(b) - inter
    return inter / torch.clamp(union, min=1e-10)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs IoU: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    return iou_pairwise(a[..., :, None, :], b[..., None, :, :])


# ---------------------------------------------------------------------------
# YOLOv2 decode (arXiv:1612.08242 §2)
# ---------------------------------------------------------------------------


def decode_v2(
    head: torch.Tensor,
    anchors: Sequence[Tuple[float, float]],
) -> Dict[str, torch.Tensor]:
    """Decode a raw v2 head (N, H, W, A, 5+C) to normalized boxes.

    bx = (sigma(tx) + cx) / W,  by = (sigma(ty) + cy) / H
    bw = pw * exp(tw) / W,      bh = ph * exp(th) / H
    conf = sigma(to),           probs = softmax(tc)

    Returns dict with xy (N,H,W,A,2), wh (N,H,W,A,2), corners (N,H,W,A,4),
    conf (N,H,W,A), probs (N,H,W,A,C), scores = conf*probs.
    """
    h, w = head.shape[-4], head.shape[-3]
    dev = head.device
    anc = torch.tensor(anchors, dtype=torch.float32, device=dev)  # (A, 2)
    cy, cx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    grid = torch.stack([cx, cy], dim=-1)[..., None, :]  # (H, W, 1, 2)
    scale = torch.tensor([w, h], dtype=torch.float32, device=dev)

    txy = head[..., 0:2]
    twh = head[..., 2:4]
    to = head[..., 4]
    tc = head[..., 5:]

    xy = (torch.sigmoid(txy) + grid) / scale
    wh = anc * torch.exp(twh) / scale
    conf = torch.sigmoid(to)
    probs = torch.softmax(tc, dim=-1)
    corners = xywh_to_corners(xy, wh)
    return {
        "xy": xy,
        "wh": wh,
        "corners": corners,
        "conf": conf,
        "probs": probs,
        "scores": conf[..., None] * probs,
    }


# ---------------------------------------------------------------------------
# YOLOv1 head split + decode (arXiv:1506.02640 §2; Darknet detection layer)
# ---------------------------------------------------------------------------


def split_v1_head(
    flat: torch.Tensor, grid: int, boxes_per_cell: int, num_classes: int
) -> Dict[str, torch.Tensor]:
    """Split the flat v1 FC output into Darknet detection-layer order:
    [S*S*C class probs, S*S*B confidences, S*S*B*4 boxes].

    Returns probs (N,S,S,C), conf (N,S,S,B), boxes_raw (N,S,S,B,4).
    """
    s, b, c = grid, boxes_per_cell, num_classes
    n = flat.shape[0]
    probs = flat[:, : s * s * c].reshape(n, s, s, c)
    conf = flat[:, s * s * c : s * s * (c + b)].reshape(n, s, s, b)
    boxes = flat[:, s * s * (c + b) :].reshape(n, s, s, b, 4)
    return {"probs": probs, "conf": conf, "boxes_raw": boxes}


def decode_v1(
    flat: torch.Tensor,
    grid: int,
    boxes_per_cell: int,
    num_classes: int,
    *,
    sqrt: bool = True,
) -> Dict[str, torch.Tensor]:
    """Decode v1: x,y are cell-relative offsets; w,h are sqrt-space when
    ``sqrt`` (Darknet yolov1 cfg sqrt=1), normalized to the image.
    """
    parts = split_v1_head(flat, grid, boxes_per_cell, num_classes)
    raw = parts["boxes_raw"]
    s = grid
    cy, cx = torch.meshgrid(
        torch.arange(s, dtype=torch.float32, device=flat.device),
        torch.arange(s, dtype=torch.float32, device=flat.device),
        indexing="ij")
    cx, cy = cx[None, :, :, None], cy[None, :, :, None]
    x = (raw[..., 0] + cx) / s
    y = (raw[..., 1] + cy) / s
    if sqrt:
        wh = torch.square(raw[..., 2:4])
    else:
        wh = raw[..., 2:4]
    xy = torch.stack([x, y], dim=-1)
    corners = xywh_to_corners(xy, wh)
    scores = parts["conf"][..., None] * parts["probs"][..., None, :]
    return {
        "xy": xy,
        "wh": wh,
        "corners": corners,
        "conf": parts["conf"],
        "probs": parts["probs"],
        "scores": scores,  # (N, S, S, B, C)
    }
