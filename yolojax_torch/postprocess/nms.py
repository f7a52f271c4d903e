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

So does the top-K select: :func:`topk_select_torch` (plain PyTorch, the
CPU path) and :func:`yolojax_torch.postprocess.cuda_topk.topk_select_cuda`
(``csrc/topk_select.cu``, every CUDA tensor). Both return what a stable
descending sort returns in its first K columns: tied scores keep index
order as ``lax.top_k`` does (``torch.topk`` does not).

Per-class NMS in one pass: each candidate's corners are shifted by
``class_id * CLASS_OFFSET`` so boxes of different classes never overlap.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from yolojax_torch.ops.boxes import decode_v1, decode_v2, decode_v3, iou_matrix

CLASS_OFFSET = 4.0  # > any normalized box extent

_USE_PALLAS = ("auto", "always", "never")
_CANDIDATES = ("auto", "exact", "approx")

# the top-K select's geometry (csrc/topk_select.cu): the keys one CTA holds
# in shared memory, and its threads, whose load groups give the floor
TOPK_MAX_SLICE = 24576
TOPK_THREADS = 512
# the select's three radix digits, most significant first: (shift, bits)
_TOPK_DIGITS = ((21, 11), (10, 11), (0, 10))


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


def score_keys(x: torch.Tensor) -> torch.Tensor:
    """f32 scores -> int64 keys in [1, 2**32) in the order of a descending
    stable sort: negatives below positives, -0.0 equal to +0.0, every NaN
    above +inf. The kernel's 32-bit key; 0 is no score's key."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = u.masked_fill(u == 0x80000000, 0)
    key = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    return key.masked_fill(torch.isnan(x), 0xFFFFFFFF)


def topk_plan(length: int, k: int,
              slices: Optional[int] = None) -> List[Tuple[int, int]]:
    """The select's levels for rows of ``length`` scores: (slices, slice
    length) each, the last (1, count). A row that fits one CTA is one
    level; a longer one is cut into slices of at most
    :data:`TOPK_MAX_SLICE` (``slices`` forces the first level's count),
    and each level keeps min(k, slice) keys a slice for the next."""
    def ceil_div(a, b):
        return -(-a // b)

    plan, n = [], length
    while True:
        s = slices if slices is not None and not plan else ceil_div(
            n, TOPK_MAX_SLICE)
        ls = 4 * ceil_div(ceil_div(n, max(s, 1)), 4)  # 16-byte aligned
        s = ceil_div(n, ls)
        if s == 1:
            return plan + [(1, n)]
        plan.append((s, ls))
        n = (s - 1) * k + min(k, n - (s - 1) * ls)


def _topk_level(keys: torch.Tensor, idx: torch.Tensor, k: int, s: int,
                ls: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One level of the select over rows of keys (N, n) and their indices:
    each slice's min(k, slice) largest keys by (key descending, index
    ascending), in index order, the slices one after another."""
    rows, n = keys.shape
    kp = F.pad(keys, (0, s * ls - n)).view(rows, s, ls)  # 0: no key
    ip = F.pad(idx, (0, s * ls - n)).view(rows, s, ls)
    n_s = (n - torch.arange(s, device=keys.device) * ls).clamp(max=ls)
    k_s = n_s.clamp(max=k)
    # the floor: the k_s-th largest of the load groups' maxima cut to its
    # top 22 bits, where a group (position // 4 modulo the CTA's threads)
    # is one thread's loads
    group = 4 * TOPK_THREADS
    gp = F.pad(kp, (0, -ls % group)).view(rows, s, -1, TOPK_THREADS, 4)
    maxima = gp.amax(dim=(2, 4)).sort(dim=-1, descending=True).values
    at = (k_s - 1).clamp(max=TOPK_THREADS - 1).expand(rows, s)
    kth = maxima.gather(-1, at[..., None])[..., 0] & ~0x3FF
    floor = kth.where(k_s <= ((n_s + 3) // 4).clamp(max=TOPK_THREADS),
                      1).clamp(min=1)
    # the k_s-th largest key t by its three digits, and how many keys
    # equal to t it takes (rem)
    rem = k_s.expand(rows, s).clone()
    prefix = keys.new_zeros((rows, s))
    mask = 0
    for shift, bits in _TOPK_DIGITS:
        bins = 1 << bits
        match = (kp >= floor[..., None]) & ((kp & mask) == prefix[..., None])
        hist = keys.new_zeros((rows, s, bins)).scatter_add_(
            2, (kp >> shift) & (bins - 1), match.long())
        above = hist.flip(-1).cumsum(-1).flip(-1) - hist
        hit = (above < rem[..., None]) & (above + hist >= rem[..., None])
        b = hit.int().argmax(-1, keepdim=True)
        rem = rem - above.gather(-1, b)[..., 0]
        prefix = prefix | (b[..., 0] << shift)
        mask |= (bins - 1) << shift
    # survivors in index order: every key above t, then the first rem
    # keys equal to t
    gt = kp > prefix[..., None]
    eq = kp == prefix[..., None]
    keep = gt | (eq & (eq.cumsum(-1) - eq.long() < rem[..., None]))
    at = torch.where(keep, keep.cumsum(-1) - 1, k)
    out_k = kp.new_zeros((rows, s, k + 1)).scatter_(2, at, kp)[..., :k]
    out_i = ip.new_zeros((rows, s, k + 1)).scatter_(2, at, ip)[..., :k]
    count = (s - 1) * k + min(k, n - (s - 1) * ls)
    return (out_k.reshape(rows, s * k)[:, :count],
            out_i.reshape(rows, s * k)[:, :count])


def topk_select_torch(scores: torch.Tensor, k: int,
                      slices: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of ``csrc/topk_select.cu``: scores (N, L) f32 ->
    (values (N, k) f32, indices (N, k) int64), equal to
    ``torch.sort(scores, 1, descending=True, stable=True)``'s first k
    columns. It repeats the kernel's steps: the key map, each level's
    per-slice floor and digit histograms, the k-th key, the tie fill in
    index order, and the survivors' stable sort. ``slices`` forces the
    first level's slice count (the result does not depend on it)."""
    n, length = scores.shape
    keys = score_keys(scores)
    idx = torch.arange(length, device=scores.device).expand(n, length)
    for s, ls in topk_plan(length, k, slices):
        keys, idx = _topk_level(keys, idx, k, s, ls)
    order = torch.sort(keys, dim=1, descending=True, stable=True).indices
    idx = idx.gather(1, order)
    return scores.gather(1, idx), idx


def _select_candidates(
    corners: torch.Tensor,  # (N, M, 4)
    scores: torch.Tensor,   # (N, M, C) conf * class prob
    score_thresh: float,
    top_k: int,
    candidates: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-K (box, class) candidates per image, sorted by descending score.

    Exact top-K, as a stable descending sort orders it: equal scores keep
    index order, as ``lax.top_k`` orders them (``topk_select_cuda``: the
    kernel for a CUDA tensor, its plain twin on the CPU). ``candidates``
    takes yolojax's values; "approx" is a TPU-only selection and, as on
    yolojax's other backends, every value resolves to exact.
    """
    if candidates not in _CANDIDATES:
        raise ValueError(f"candidates={candidates!r}: expected one of "
                         f"{_CANDIDATES}")
    n, m, c = scores.shape
    flat = scores.reshape(n, m * c)
    top_k = min(top_k, m * c)
    from yolojax_torch.postprocess.cuda_topk import topk_select_cuda

    top_scores, top_idx = topk_select_cuda(flat, top_k)
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
