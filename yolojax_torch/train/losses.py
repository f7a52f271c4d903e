"""The YOLO v1 and v2 objectives (port of ``yolojax/train/losses.py``).

Each loss is one function of (head, padded ground truth), vectorised over
the batch with no data-dependent host control flow, so a step on the card
never waits for the host.

Ground truth, padded to a fixed count G:
  gt_xywh:  (N, G, 4) normalised (cx, cy, w, h) in [0, 1]
  gt_class: (N, G) int
  gt_valid: (N, G) bool (padding mask)

Target gridding. yolojax scatters each GT into its (cell, anchor) slot
with ``.at[...].set(mode="drop")``, after sending padding and losing
duplicates (several valid GTs on one slot, where the last one wins) to an
out-of-range row that XLA drops. ``index_put_`` raises on such rows, so
here the non-survivors go to one spare row past the end of the flattened
target buffer, which is cut off afterwards: every surviving GT owns its
slot alone, so the scatter is deterministic, and the spare row's value is
never read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from yolojax_torch.ops.boxes import (
    iou_matrix,
    iou_pairwise,
    split_v1_head,
    xywh_to_corners,
)


def _mask_duplicate_slots(slot: torch.Tensor,
                          gt_valid: torch.Tensor) -> torch.Tensor:
    """Bool (N, G) mask of the GTs that keep their target slot: a valid GT
    loses when a LATER valid GT is bound for the same slot (Darknet's
    sequential overwrite: the last GT in the padded list wins)."""
    g = slot.shape[1]
    same = slot[:, :, None] == slot[:, None, :]
    idx = torch.arange(g, device=slot.device)
    later = idx[None, :] > idx[:, None]
    loser = torch.any(same & later[None] & gt_valid[:, None, :], dim=-1)
    return gt_valid & ~loser


def _const(values, device: torch.device) -> torch.Tensor:
    """A small f32 constant on ``device``. From pinned memory the upload is
    asynchronous; from pageable memory it would wait for the stream, and
    with it for the whole forward pass."""
    t = torch.tensor(values, dtype=torch.float32)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _scatter(lin: torch.Tensor, size: int, values: torch.Tensor,
             shape: Tuple[int, ...]) -> torch.Tensor:
    """Targets of shape ``shape`` (+ values' trailing depth), zero except at
    the flat positions ``lin`` (N, G); ``lin == size`` is the spare row."""
    depth = values.shape[2:]
    buf = torch.zeros((size + 1,) + depth, dtype=torch.float32,
                      device=values.device)
    buf.index_put_((lin.reshape(-1),),
                   values.reshape((-1,) + depth).float())
    return buf[:size].reshape(shape + depth)


# ---------------------------------------------------------------------------
# YOLOv2
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class YoloV2LossConfig:
    """Darknet region-layer defaults (yolo-voc.cfg)."""

    coord_scale: float = 1.0
    object_scale: float = 5.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0
    iou_thresh: float = 0.6  # anchors above this best-IoU escape noobj loss
    rescore: bool = True  # objectness target = IoU (else 1.0)
    coord_area_weight: bool = True  # (2 - w*h) coord weight per truth
    prior_scale: float = 0.0  # early-training prior matching; 0 disables


def yolo_v2_loss(
    head: torch.Tensor,  # (N, H, W, A, 5+C) raw
    anchors: Tuple[Tuple[float, float], ...],
    gt_xywh: torch.Tensor,
    gt_class: torch.Tensor,
    gt_valid: torch.Tensor,
    cfg: YoloV2LossConfig = YoloV2LossConfig(),
) -> Dict[str, torch.Tensor]:
    """v2 objective: a dict of scalar terms plus 'total', each summed per
    image and averaged over the batch."""
    n, h, w, a, _ = head.shape
    c = head.shape[-1] - 5
    dev = head.device
    f32 = torch.float32
    anc = _const(anchors, dev)  # (A, 2) grid units
    scale = _const([w, h], dev)

    head = head.float()
    txy, twh = head[..., 0:2], head[..., 2:4]
    sxy = torch.sigmoid(txy)
    conf = torch.sigmoid(head[..., 4])
    probs = torch.softmax(head[..., 5:], dim=-1)

    cy, cx = torch.meshgrid(torch.arange(h, dtype=f32, device=dev),
                            torch.arange(w, dtype=f32, device=dev),
                            indexing="ij")
    grid = torch.stack([cx, cy], -1)[None, :, :, None, :]  # (1,H,W,1,2)
    pred_xy = (sxy + grid) / scale
    pred_wh = anc * torch.exp(twh) / scale
    pred_corners = xywh_to_corners(pred_xy, pred_wh)  # (N,H,W,A,4)

    g = gt_xywh.shape[1]
    gt_valid = gt_valid.bool()
    # ---- per-GT assignment: cell + best anchor (first max on ties) -------
    gxy = gt_xywh[..., 0:2].float()
    gwh = gt_xywh[..., 2:4].float()
    cell = torch.floor(gxy * scale)
    cell = torch.minimum(torch.clamp(cell, min=0.0), scale - 1)
    gwh_grid = gwh * scale
    inter = torch.minimum(gwh_grid[:, :, None, :], anc[None, None]).prod(-1)
    union = gwh_grid.prod(-1)[:, :, None] + anc.prod(-1)[None, None] - inter
    anchor_iou = inter / torch.clamp(union, min=1e-10)  # (N,G,A)
    best_a = torch.argmax(anchor_iou, dim=-1)

    ci = cell[..., 0].long()
    cj = cell[..., 1].long()
    slot = (cj * w + ci) * a + best_a
    keep_gt = _mask_duplicate_slots(
        torch.where(gt_valid, slot, torch.full_like(slot, h * w * a)),
        gt_valid)
    size = n * h * w * a
    n_idx = torch.arange(n, device=dev)[:, None]
    lin = torch.where(keep_gt, n_idx * (h * w * a) + slot,
                      torch.full_like(slot, size))
    valid = keep_gt.to(f32)

    t_xy_star = gxy * scale - cell
    pw = anc[best_a]  # (N,G,2)
    t_wh_star = torch.log(torch.clamp(gwh_grid, min=1e-8)
                          / torch.clamp(pw, min=1e-8))

    def scat(values):
        return _scatter(lin, size, values, (n, h, w, a))

    obj_mask = scat(valid)
    txy_t = scat(t_xy_star)
    twh_t = scat(t_wh_star)
    onehot = torch.nn.functional.one_hot(gt_class.long().clamp(0, c - 1), c)
    onehot = onehot * (gt_class[..., None] >= 0) * (gt_class[..., None] < c)
    cls_t = scat(onehot.to(f32) * valid[..., None])
    gt_corner_t = scat(xywh_to_corners(gxy, gwh))
    if cfg.coord_area_weight:
        cw = scat(2.0 - gwh.prod(-1))
    else:
        cw = obj_mask

    # ---- objectness target: IoU of the predicted box at assigned slots ---
    iou_at = iou_pairwise(pred_corners, gt_corner_t)
    obj_target = iou_at if cfg.rescore else torch.ones_like(iou_at)

    # ---- noobj mask: every valid GT (duplicates too) exempts its matches -
    gt_corners = xywh_to_corners(gxy, gwh)  # (N,G,4)
    pc = pred_corners.reshape(n, h * w * a, 4)
    all_iou = iou_matrix(pc, gt_corners) * gt_valid.to(f32)[:, None, :]
    best_iou = torch.max(all_iou, dim=-1).values.reshape(n, h, w, a)
    noobj_mask = (best_iou <= cfg.iou_thresh).to(f32) * (1.0 - obj_mask)

    # ---- terms ------------------------------------------------------------
    def per_img(x):
        return x.reshape(n, -1).sum(-1)

    coord = cfg.coord_scale * per_img(
        cw[..., None] * obj_mask[..., None]
        * (torch.square(sxy - txy_t) + torch.square(twh - twh_t)))
    obj = cfg.object_scale * per_img(
        obj_mask * torch.square(conf - obj_target.detach()))
    noobj = cfg.noobject_scale * per_img(noobj_mask * torch.square(conf))
    cls = cfg.class_scale * per_img(
        obj_mask[..., None] * torch.square(probs - cls_t))
    terms = {
        "coord": coord.mean(),
        "object": obj.mean(),
        "noobject": noobj.mean(),
        "class": cls.mean(),
    }
    if cfg.prior_scale > 0.0:
        prior = cfg.prior_scale * per_img(
            (1.0 - obj_mask)[..., None]
            * (torch.square(sxy - 0.5) + torch.square(twh)))
        terms["prior"] = prior.mean()
    terms["total"] = sum(terms.values())
    return terms


# ---------------------------------------------------------------------------
# YOLOv1
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class YoloV1LossConfig:
    coord_scale: float = 5.0  # lambda_coord
    noobject_scale: float = 0.5  # lambda_noobj
    object_scale: float = 1.0
    class_scale: float = 1.0
    rescore: bool = True  # conf target = IoU (Darknet yolov1 rescore=1)
    sqrt: bool = True  # predictions carry sqrt(w), sqrt(h)


def yolo_v1_loss(
    flat: torch.Tensor,  # (N, S*S*(C+5B)) raw FC output
    grid: int,
    boxes_per_cell: int,
    num_classes: int,
    gt_xywh: torch.Tensor,
    gt_class: torch.Tensor,
    gt_valid: torch.Tensor,
    cfg: YoloV1LossConfig = YoloV1LossConfig(),
) -> Dict[str, torch.Tensor]:
    """v1 objective (arXiv:1506.02640 eq. 3); one GT per cell, the last
    valid GT in the padded list wins the cell."""
    s, b, c = grid, boxes_per_cell, num_classes
    f32 = torch.float32
    n = flat.shape[0]
    dev = flat.device
    parts = split_v1_head(flat.float(), s, b, c)
    probs = parts["probs"]  # (N,S,S,C)
    conf = parts["conf"]  # (N,S,S,B)
    raw = parts["boxes_raw"]  # (N,S,S,B,4)

    gt_valid = gt_valid.bool()
    gxy = gt_xywh[..., 0:2].float()
    gwh = gt_xywh[..., 2:4].float()
    cell = torch.clamp(torch.floor(gxy * s), 0, s - 1)
    ci = cell[..., 0].long()
    cj = cell[..., 1].long()
    slot = cj * s + ci
    keep_gt = _mask_duplicate_slots(
        torch.where(gt_valid, slot, torch.full_like(slot, s * s)), gt_valid)
    size = n * s * s
    n_idx = torch.arange(n, device=dev)[:, None]
    lin = torch.where(keep_gt, n_idx * (s * s) + slot,
                      torch.full_like(slot, size))

    def scat(values):
        return _scatter(lin, size, values, (n, s, s))

    has_obj = scat(keep_gt.to(f32))
    cell_xy = scat(gxy)
    cell_wh = scat(gwh)
    onehot = torch.nn.functional.one_hot(gt_class.long().clamp(0, c - 1), c)
    onehot = onehot * (gt_class[..., None] >= 0) * (gt_class[..., None] < c)
    cell_cls = scat(onehot.to(f32) * keep_gt[..., None].to(f32))

    idx = torch.arange(s, dtype=f32, device=dev)
    cxg = idx[None, None, :, None]
    cyg = idx[None, :, None, None]
    px = (raw[..., 0] + cxg) / s
    py = (raw[..., 1] + cyg) / s
    pwh = torch.square(raw[..., 2:4]) if cfg.sqrt else raw[..., 2:4]
    pred_corners = xywh_to_corners(torch.stack([px, py], -1), pwh)

    gt_corners = xywh_to_corners(cell_xy, cell_wh)[..., None, :]
    iou = iou_pairwise(pred_corners, gt_corners.expand(pred_corners.shape))
    # responsible box: argmax IoU among the B predictors (first on ties)
    resp = torch.nn.functional.one_hot(torch.argmax(iou, dim=-1), b).to(f32)
    resp = resp * has_obj[..., None]

    t_xy = cell_xy * s - torch.floor(cell_xy * s)
    t_wh = torch.sqrt(torch.clamp(cell_wh, min=0.0)) if cfg.sqrt else cell_wh

    def per_img(x):
        return x.reshape(n, -1).sum(-1)

    xy_err = torch.square(raw[..., 0:2] - t_xy[..., None, :]).sum(-1)
    wh_err = torch.square(raw[..., 2:4] - t_wh[..., None, :]).sum(-1)
    coord = cfg.coord_scale * per_img(resp * (xy_err + wh_err))
    conf_target = iou.detach() if cfg.rescore else 1.0
    obj = cfg.object_scale * per_img(resp * torch.square(conf - conf_target))
    noobj = cfg.noobject_scale * per_img((1.0 - resp) * torch.square(conf))
    cls = cfg.class_scale * per_img(
        has_obj[..., None] * torch.square(probs - cell_cls))
    terms = {
        "coord": coord.mean(),
        "object": obj.mean(),
        "noobject": noobj.mean(),
        "class": cls.mean(),
    }
    terms["total"] = sum(terms.values())
    return terms
