"""Plain reference of YOLOv2 detection after the network: the region
decode (arXiv:1612.08242 section 2), exact top-K, greedy per-class NMS,
the letterbox, a binary PPM reader and the map back to image pixels.

Float32 PyTorch and numpy; imports nothing of the program. Two formulas
are frozen copies of the program's own choices, so that an exact
comparison is possible where the program is exact:

* the IoU's operation order (the program's NMS kernel repeats it bit for
  bit), and greedy NMS over all classes at once with each box shifted by
  class * 4.0, which equals per-class NMS up to that shift's rounding;
* the letterbox rounds the scaled size to the nearest pixel and centres
  it with floor division (Darknet's ``letterbox_image`` truncates).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

CLASS_OFFSET = 4.0


def decode(head: torch.Tensor, anchors: Sequence[Sequence[float]]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw head (N, h, w, A, 5 + C) -> corners (N, M, 4) as (ymin, xmin,
    ymax, xmax) normalised, scores (N, M, C) = sigmoid(to) * softmax(tc);
    M = h * w * A in that order."""
    n, h, w, a, _ = head.shape
    dev = head.device
    anc = torch.tensor(anchors, dtype=torch.float32, device=dev)
    cy, cx = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    bx = (torch.sigmoid(head[..., 0]) + cx[:, :, None]) / w
    by = (torch.sigmoid(head[..., 1]) + cy[:, :, None]) / h
    bw = anc[:, 0] * torch.exp(head[..., 2]) / w
    bh = anc[:, 1] * torch.exp(head[..., 3]) / h
    corners = torch.stack([by - bh / 2, bx - bw / 2, by + bh / 2,
                           bx + bw / 2], dim=-1)
    scores = torch.sigmoid(head[..., 4])[..., None] * torch.softmax(
        head[..., 5:], dim=-1)
    return corners.reshape(n, -1, 4), scores.reshape(n, h * w * a, -1)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs IoU (..., K, 4) x (..., L, 4) -> (..., K, L)."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    lo = torch.maximum(a[..., :2], b[..., :2])
    hi = torch.minimum(a[..., 2:], b[..., 2:])
    hw = torch.clamp(hi - lo, min=0)
    inter = hw[..., 0] * hw[..., 1]

    def area(t):
        return (torch.clamp(t[..., 2] - t[..., 0], min=0)
                * torch.clamp(t[..., 3] - t[..., 1], min=0))

    union = area(a) + area(b) - inter
    return inter / torch.clamp(union, min=1e-10)


def greedy_nms(boxes: torch.Tensor, classes: torch.Tensor,
               valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """keep (N, K): boxes (N, K, 4) sorted by descending score; box i is
    kept iff valid and no kept earlier box of its class overlaps it by
    more than ``iou_thresh``."""
    shifted = boxes + (classes.float() * CLASS_OFFSET)[..., None]
    over = iou_matrix(shifted, shifted) > torch.tensor(iou_thresh,
                                                       dtype=torch.float32)
    n, k = valid.shape
    keep = torch.zeros((n, k), dtype=torch.bool, device=boxes.device)
    for i in range(k):
        keep[:, i] = valid[:, i] & ~(over[:, i, :i] & keep[:, :i]).any(1)
    return keep


def detections(corners: torch.Tensor, scores: torch.Tensor, *,
               top_k: int, score_thresh: float, iou_thresh: float
               ) -> Dict[str, torch.Tensor]:
    """The K best (box, class) pairs of each image by a stable descending
    sort, and their keep mask: the program's output contract, and
    ``index``, each candidate's box * C + class."""
    n, m, c = scores.shape
    top, idx = torch.sort(scores.reshape(n, m * c), dim=1, descending=True,
                          stable=True)
    top, idx = top[:, :top_k], idx[:, :top_k]
    boxes = torch.gather(corners, 1, (idx // c)[..., None].expand(-1, -1, 4))
    classes = idx % c
    keep = greedy_nms(boxes, classes, top > score_thresh, iou_thresh)
    return {"boxes": boxes, "scores": top, "classes": classes, "keep": keep,
            "index": idx}


def letterbox_geometry(w: int, h: int, dim: int) -> Tuple[int, int, int, int]:
    """(new_w, new_h, pad_x, pad_y) in pixels of the ``dim`` canvas."""
    r = min(dim / w, dim / h)
    nw, nh = int(round(w * r)), int(round(h * r))
    return nw, nh, (dim - nw) // 2, (dim - nh) // 2


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int
                    ) -> torch.Tensor:
    """(H, W, C) float -> (out_h, out_w, C): bilinear with half-pixel
    centres, edge samples clamped, no antialiasing."""
    h, w = img.shape[:2]

    def taps(n_in, n_out):
        src = (torch.arange(n_out, dtype=torch.float32, device=img.device)
               + 0.5) * (n_in / n_out) - 0.5
        src = torch.clamp(src, min=0)
        i0 = torch.clamp(src.floor().long(), max=n_in - 1)
        i1 = torch.clamp(i0 + 1, max=n_in - 1)
        return i0, i1, (src - i0.float())

    y0, y1, fy = taps(h, out_h)
    x0, x1, fx = taps(w, out_w)
    fy, fx = fy[:, None, None], fx[None, :, None]
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def letterbox(img: torch.Tensor, dim: int) -> torch.Tensor:
    """uint8 (H, W, 3) RGB -> float32 (dim, dim, 3) in [0, 1]: the image
    scaled to fit, centred on a 0.5 grey canvas."""
    h, w = img.shape[:2]
    nw, nh, px, py = letterbox_geometry(w, h, dim)
    canvas = torch.full((dim, dim, 3), 0.5, dtype=torch.float32,
                        device=img.device)
    canvas[py:py + nh, px:px + nw] = resize_bilinear(img.float() / 255.0,
                                                     nh, nw)
    return canvas


def parse_ppm(data: bytes) -> np.ndarray:
    """Binary 8-bit PPM (P6) -> uint8 (H, W, 3)."""
    fields, pos = [], 2
    if data[:2] != b"P6":
        raise ValueError("not a binary PPM")
    while len(fields) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    w, h, maxval = fields
    if maxval != 255:
        raise ValueError(f"PPM maxval {maxval}: only 8-bit is read")
    pos += 1  # the single whitespace byte before the raster
    return np.frombuffer(data, np.uint8, 3 * w * h, pos).reshape(h, w, 3)


def encode_ppm(img: np.ndarray) -> bytes:
    h, w = img.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(
        img, np.uint8).tobytes()


def to_pixels(corners: torch.Tensor, w: int, h: int, dim: int
              ) -> torch.Tensor:
    """Normalised canvas corners (..., 4) (ymin, xmin, ymax, xmax) ->
    original-image pixels (x0, y0, x1, y1)."""
    nw, nh, px, py = letterbox_geometry(w, h, dim)
    sx, sy, pxn, pyn = nw / dim, nh / dim, px / dim, py / dim
    return torch.stack([(corners[..., 1] - pxn) / sx * w,
                        (corners[..., 0] - pyn) / sy * h,
                        (corners[..., 3] - pxn) / sx * w,
                        (corners[..., 2] - pyn) / sy * h], dim=-1)

