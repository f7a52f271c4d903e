"""Detection post-processing: confidence threshold + per-class greedy NMS.

Port of ``yolojax/postprocess/nms.py``. The pipeline is batched and stays
on the device:

  decode -> top-K candidate select -> class-offset trick -> greedy NMS

The greedy sweep exists twice with identical semantics:
  * :func:`nms_greedy_torch` — plain PyTorch (the twin of yolojax's
    ``nms_greedy_lax``); the CPU path and the reference for the kernel;
  * :func:`yolojax_torch.postprocess.cuda_nms.nms_greedy_cuda` — the
    hand-written CUDA kernel (``csrc/nms_greedy.cu``), taken for every
    CUDA tensor unless ``use_pallas="never"`` asks for the plain sweep.

Per-class NMS in one pass: each candidate's corners are shifted by
``class_id * CLASS_OFFSET`` so boxes of different classes never overlap.
Candidates are sorted by descending score with a stable sort, so tied
scores keep index order as ``lax.top_k`` does (``torch.topk`` does not).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from yolojax_torch.ops.boxes import decode_v1, decode_v2, decode_v3, iou_matrix

CLASS_OFFSET = 4.0  # > any normalized box extent

_USE_PALLAS = ("auto", "always", "never")
_CANDIDATES = ("auto", "exact", "approx")


def nms_greedy_torch(boxes: torch.Tensor, valid: torch.Tensor,
                     iou_thresh: float) -> torch.Tensor:
    """Batched greedy NMS sweep. boxes (N, K, 4) score-sorted corner boxes,
    valid (N, K) bool -> keep (N, K) bool: keep[i] iff valid[i] and no
    earlier kept box overlaps box i with IoU > ``iou_thresh``."""
    n, k = valid.shape
    thresh = torch.tensor(iou_thresh, dtype=torch.float32)
    overlap = iou_matrix(boxes, boxes) > thresh  # (N, K, K)
    valid = valid.bool()
    keep = torch.zeros((n, k), dtype=torch.bool, device=boxes.device)
    for i in range(k):
        sup = (overlap[:, i, :i] & keep[:, :i]).any(dim=1)
        keep[:, i] = valid[:, i] & ~sup
    return keep


def batched_nms(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
                *, use_pallas: str = "auto") -> torch.Tensor:
    """Greedy NMS over a batch. boxes (N,K,4), valid (N,K) -> (N,K) bool.

    ``use_pallas`` keeps yolojax's INI values: "auto" and "always" take the
    CUDA kernel for a CUDA tensor (the plain sweep for a CPU tensor);
    "never" asks for the plain sweep on any device.
    """
    if use_pallas not in _USE_PALLAS:
        raise ValueError(f"use_pallas={use_pallas!r}: expected one of "
                         f"{_USE_PALLAS}")
    if use_pallas == "never":
        return nms_greedy_torch(boxes, valid, iou_thresh)
    from yolojax_torch.postprocess.cuda_nms import nms_greedy_cuda

    return nms_greedy_cuda(boxes, valid, iou_thresh)


def _select_candidates(
    corners: torch.Tensor,  # (N, M, 4)
    scores: torch.Tensor,   # (N, M, C) conf * class prob
    score_thresh: float,
    top_k: int,
    candidates: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-K (box, class) candidates per image, sorted by descending score.

    Exact top-K by a stable descending sort: equal scores keep index
    order, as ``lax.top_k`` orders them. ``candidates`` takes yolojax's
    values; "approx" is a TPU-only selection and, as on yolojax's other
    backends, every value resolves to exact.
    """
    if candidates not in _CANDIDATES:
        raise ValueError(f"candidates={candidates!r}: expected one of "
                         f"{_CANDIDATES}")
    n, m, c = scores.shape
    flat = scores.reshape(n, m * c)
    top_k = min(top_k, m * c)
    top_scores, top_idx = torch.sort(flat, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :top_k], top_idx[:, :top_k]
    box_idx = top_idx // c
    cls_idx = top_idx % c
    top_boxes = torch.gather(corners, 1, box_idx[..., None].expand(-1, -1, 4))
    valid = top_scores > score_thresh
    return top_boxes, top_scores, cls_idx, valid


def _run_nms(corners, scores, score_thresh, iou_thresh, top_k, use_pallas,
             candidates="auto") -> Dict[str, torch.Tensor]:
    boxes, top_scores, classes, valid = _select_candidates(
        corners, scores, score_thresh, top_k, candidates
    )
    shifted = boxes + (classes.float() * CLASS_OFFSET)[..., None]
    keep = batched_nms(shifted, valid, iou_thresh, use_pallas=use_pallas)
    return {
        "boxes": boxes,        # (N, K, 4) normalized corners
        "scores": top_scores,  # (N, K)
        "classes": classes,    # (N, K) int64
        "keep": keep,          # (N, K) bool
    }


def postprocess_v2(
    head: torch.Tensor,
    anchors: Tuple[Tuple[float, float], ...],
    score_thresh: float = 0.3,
    iou_thresh: float = 0.4,
    top_k: int = 256,
    use_pallas: str = "auto",
    candidates: str = "auto",
) -> Dict[str, torch.Tensor]:
    """Full v2 detect postprocess: raw head (N,H,W,A,5+C) -> detections."""
    dec = decode_v2(head, anchors)
    n = head.shape[0]
    m = head.shape[1] * head.shape[2] * head.shape[3]
    corners = dec["corners"].reshape(n, m, 4)
    scores = dec["scores"].reshape(n, m, -1)
    return _run_nms(corners, scores, score_thresh, iou_thresh, top_k,
                    use_pallas, candidates)


def postprocess_v3(
    heads: Tuple[torch.Tensor, ...],
    anchors: Tuple[Tuple[float, float], ...],
    masks: Tuple[Tuple[int, ...], ...],
    input_hw: Tuple[int, int],
    score_thresh: float = 0.3,
    iou_thresh: float = 0.45,
    top_k: int = 256,
    use_pallas: str = "auto",
    candidates: str = "auto",
) -> Dict[str, torch.Tensor]:
    """v3 detect postprocess: raw heads, each (N,H,W,A,5+C), -> detections.
    The heads' candidates are concatenated in head order (Darknet's layer
    order: the coarsest grid first), then top-K, shift and NMS as v2."""
    decs = decode_v3(heads, anchors, masks, input_hw)
    n = heads[0].shape[0]
    corners = torch.cat([d["corners"].reshape(n, -1, 4) for d in decs], 1)
    scores = torch.cat([d["scores"].reshape(n, -1, d["scores"].shape[-1])
                        for d in decs], 1)
    return _run_nms(corners, scores, score_thresh, iou_thresh, top_k,
                    use_pallas, candidates)


def postprocess_v1(
    flat: torch.Tensor,
    grid: int,
    boxes_per_cell: int,
    num_classes: int,
    score_thresh: float = 0.2,
    iou_thresh: float = 0.4,
    top_k: int = 128,
    use_pallas: str = "auto",
    sqrt: bool = True,
    candidates: str = "auto",
) -> Dict[str, torch.Tensor]:
    """v1 detect postprocess: flat FC head (N, S*S*(C+5B)) -> detections."""
    dec = decode_v1(flat, grid, boxes_per_cell, num_classes, sqrt=sqrt)
    n = flat.shape[0]
    m = grid * grid * boxes_per_cell
    corners = dec["corners"].reshape(n, m, 4)
    scores = dec["scores"].reshape(n, m, num_classes)
    return _run_nms(corners, scores, score_thresh, iou_thresh, top_k,
                    use_pallas, candidates)
