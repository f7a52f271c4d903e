"""The comparisons that decide ``correct``: the program's answers against
the plain reference's, as numbers that each have a limit of their own
(``benchmark/limits/<cell>.json``; a number the limits do not name is
printed and not compared).

Detections are compared candidate by candidate: each of the program's
candidates is matched to the reference's box and class that it stands
for (the nearest by centre, size and score), and then

* ``centre_err``: the largest gap of a match's box centre, in canvas
  units (a reply's boxes are mapped back onto the canvas);
* ``size_err``: the largest |log| ratio of a match's box sides;
* ``score_err``: the largest score gap of a match over the reference's
  score, or over the score threshold where that is larger;
* ``size_med``, ``score_med``: the medians of those two gaps over every
  candidate compared, steady where the largest gaps swing (a random
  network puts a few candidates on a knife's edge);
* ``topk_gap``: how far below the reference's K-th best score the
  program's worst candidate lies, over that K-th score (0 when the
  program's candidates are all among the reference's best);
* ``topk_out_share``, ``top2k_out_share``: the share of all the
  program's candidates that the reference scores below its K-th (2K-th)
  best: a count that a few knife-edge candidates cannot move, and that
  any other choice of K candidates fills;
* ``nms_faults``: keep entries that differ from the reference's greedy
  sweep over the program's own candidates, plus candidates out of score
  order, plus a box and class the program returns twice; exact, limit 0.

A served reply carries only the kept detections above the threshold:
:func:`compare_replies` holds it to the properties of a greedy NMS answer
over the reference's candidates (``overlap_pairs``, ``cover_gap``) and to
the reference's own answer (``miss_share``, ``extra_share``).
A training step is compared by its losses, its first gradient and the
parameters' change (:func:`compare_train`).
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.detect import (CLASS_OFFSET, greedy_nms, iou_matrix,
                                        letterbox_geometry)


def box_gaps(a: torch.Tensor, b: torch.Tensor, floor: float):
    """(centre gap, size gap) of corner boxes, broadcasting: the largest
    gap of the centres' coordinates, and the largest |log| ratio of the
    sides, each side at least ``floor`` (a canvas pixel). A side carries
    its error relative to its length: random weights make boxes many
    times the image."""
    centre = ((a[..., :2] + a[..., 2:]) - (b[..., :2] + b[..., 2:])
              ).abs().amax(-1) / 2
    size = (torch.log(torch.clamp(a[..., 2:] - a[..., :2], min=floor))
            - torch.log(torch.clamp(b[..., 2:] - b[..., :2], min=floor))
            ).abs().amax(-1)
    return centre, size


def _match(boxes, classes, scores, ref_corners, ref_scores, floor):
    """For candidates (N, K) of an image batch: the reference box each
    stands for (the least centre gap + size gap + score gap among the
    reference's boxes scored for its class), its two box gaps and the
    reference's score of it."""
    n, k = scores.shape
    m = ref_scores.shape[1]
    centre, size = box_gaps(boxes[:, :, None, :], ref_corners[:, None, :, :],
                            floor)
    s_ref = torch.gather(ref_scores.transpose(1, 2), 1,
                         classes[..., None].expand(n, k, m))  # (N, K, M)
    idx = (centre + size + (scores[..., None] - s_ref).abs()).argmin(-1)

    def at(t):
        return torch.gather(t, 2, idx[..., None])[..., 0]

    return idx, at(centre), at(size), at(s_ref)


def compare_detect(out: Dict[str, torch.Tensor], ref_corners: torch.Tensor,
                   ref_scores: torch.Tensor, *, score_thresh: float,
                   iou_thresh: float, dim: int, block: int = 16
                   ) -> Dict[str, float]:
    """``out``: the program's boxes (N, K, 4), scores (N, K), classes (N,
    K), keep (N, K) for images whose reference decode is ``ref_corners``
    (N, M, 4), ``ref_scores`` (N, M, C)."""
    worst = dict.fromkeys(("centre_err", "size_err", "score_err",
                           "topk_gap"), 0.0)
    faults = {"keep": 0, "order": 0, "repeat": 0}
    sizes, rel = [], []
    outside = {"topk_out_share": 0, "top2k_out_share": 0}
    n, k = out["scores"].shape
    for s in range(0, n, block):
        rows = slice(s, s + block)
        boxes, scores = out["boxes"][rows].float(), out["scores"][rows].float()
        classes, keep = out["classes"][rows].long(), out["keep"][rows].bool()
        corners, rscores = ref_corners[rows], ref_scores[rows]
        _, centre, size, s_ref = _match(boxes, classes, scores, corners,
                                        rscores, 1.0 / dim)
        ranked = torch.topk(rscores.reshape(rscores.shape[0], -1), 2 * k,
                            dim=1).values
        kth = ranked[:, k - 1]
        outside["topk_out_share"] += int((s_ref < kth[:, None]).sum())
        outside["top2k_out_share"] += int((s_ref < ranked[:, -1:]).sum())
        err = (scores - s_ref).abs() / torch.clamp(s_ref, min=score_thresh)
        sizes.append(size.flatten())
        rel.append(err.flatten())
        for key, v in (("centre_err", centre.max()), ("size_err", size.max()),
                       ("score_err", err.max()),
                       ("topk_gap", torch.clamp(
                           (kth - s_ref.min(1).values) / kth, min=0).max())):
            worst[key] = max(worst[key], float(v))
        same = ((boxes[:, :, None] == boxes[:, None]).all(-1)
                & (classes[:, :, None] == classes[:, None]))
        faults["repeat"] += int(same.triu(1).sum())
        faults["order"] += int((scores[:, 1:] > scores[:, :-1]).sum())
        sweep = greedy_nms(boxes, classes, scores > score_thresh, iou_thresh)
        faults["keep"] += int((sweep != keep).sum())
    if any(faults.values()):
        print(f"compare: nms faults {faults}", file=sys.stderr)
    return {**worst, "size_med": float(torch.cat(sizes).median()),
            "score_med": float(torch.cat(rel).median()),
            **{key: v / (n * k) for key, v in outside.items()},
            "nms_faults": float(sum(faults.values()))}


def to_canvas(boxes: torch.Tensor, w: int, h: int, dim: int):
    """A reply's pixel boxes (x0, y0, x1, y1) back on the normalised
    canvas as (ymin, xmin, ymax, xmax), and the canvas units of one image
    pixel along (y, x)."""
    nw, nh, px, py = letterbox_geometry(w, h, dim)
    sx, sy = nw / dim / w, nh / dim / h
    ox, oy = px / dim, py / dim
    return (torch.stack([boxes[:, 1] * sy + oy, boxes[:, 0] * sx + ox,
                         boxes[:, 3] * sy + oy, boxes[:, 2] * sx + ox], -1),
            (sy, sx))


def compare_replies(replies: List[dict], refs: List[dict], *,
                    score_thresh: float, iou_thresh: float, top_k: int
                    ) -> Dict[str, float]:
    """Served replies against the reference. ``replies[j]`` is a reply's
    JSON (``detections``: class, score, box [x0, y0, x1, y1] in pixels,
    rounded to 0.01), ``refs[j]`` the reference's decode of the same
    request: ``corners`` (M, 4) normalised, ``scores`` (M, C), the
    image's ``w``, ``h`` and the canvas ``dim``. A reply is a greedy NMS
    answer if

    * each detection is a reference candidate (``centre_err``,
      ``size_err``, ``score_err``);
    * no two detections overlap by more than ``iou_thresh``
      (``overlap_pairs``, exact but for what the reply's rounding can
      move an IoU, bounded from the two boxes' sides);
    * each reference candidate among the K best and above the threshold
      that the reply lacks is suppressed by a detection that scores as
      high and overlaps it by more than ``iou_thresh`` (``cover_gap``:
      how far the best excuse of the worst such candidate falls short,
      relative to the threshold, the K-th best score, the score or the
      overlap limit it missed);
    * the reply holds the reference's own answer: ``miss_share`` is the
      share of the reference's kept detections, over all the replies,
      that no detection of the reply of the same class overlaps by 0.5
      or more, and ``extra_share`` the share of the replies' detections
      that overlap no kept detection of the reference so; an empty or
      cut reply misses, a reply of other candidates has extras.

    Overlaps are the program's sweep's: boxes shifted by class *
    ``CLASS_OFFSET`` canvas units, which keeps classes apart only for
    boxes smaller than that."""
    worst = dict.fromkeys(("centre_err", "size_err", "score_err",
                           "cover_gap"), 0.0)
    overlap_pairs = 0
    counts = {"miss": 0, "ref": 0, "extra": 0, "got": 0}
    for reply, ref in zip(replies, refs):
        dets, dim = reply["detections"], ref["dim"]
        corners, rscores = ref["corners"], ref["scores"]
        dev = corners.device
        px = torch.tensor([d["box"] for d in dets], dtype=torch.float64,
                          device=dev).reshape(-1, 4)
        boxes, (uy, ux) = to_canvas(px, ref["w"], ref["h"], dim)
        boxes = boxes.float()
        classes = torch.tensor([int(d["class"]) for d in dets],
                               dtype=torch.long, device=dev)
        scores = torch.tensor([float(d["score"]) for d in dets],
                              dtype=torch.float32, device=dev)
        shifted = boxes + (classes.float() * CLASS_OFFSET)[:, None]
        kept = ref["kept"]
        same = (iou_matrix(kept["boxes"].float(), boxes)
                >= 0.5) & (kept["classes"][:, None] == classes[None])
        counts["ref"] += same.shape[0]
        counts["miss"] += int((~same.any(1)).sum())
        counts["got"] += same.shape[1]
        counts["extra"] += int((~same.any(0)).sum())
        matched = set()
        if dets:
            idx, centre, size, s_ref = _match(
                boxes[None], classes[None], scores[None], corners[None],
                rscores[None], 1.0 / dim)
            for key, v in (("centre_err", centre.max()),
                           ("size_err", size.max()),
                           ("score_err", ((scores - s_ref[0]).abs()
                                          / torch.clamp(s_ref[0],
                                                        min=score_thresh)
                                          ).max())):
                worst[key] = max(worst[key], float(v))
            matched = set(zip(idx[0].tolist(), classes.tolist()))
            # a 0.005-pixel move of each side moves an IoU by at most
            # about 8 x that over the shortest side of the pair
            side = torch.minimum((boxes[:, 2] - boxes[:, 0]) / uy,
                                 (boxes[:, 3] - boxes[:, 1]) / ux)
            slack = 8 * 0.005 / torch.clamp(
                torch.minimum(side[:, None], side[None]), min=1e-3)
            over = iou_matrix(shifted, shifted) > iou_thresh + slack
            overlap_pairs += int(over.triu(1).sum())
        cand = (rscores > score_thresh).nonzero()            # (E, 2)
        lacking = [k for k, (mi, ci) in enumerate(cand.tolist())
                   if (mi, ci) not in matched]
        if not lacking:
            continue
        cand = cand[lacking]
        s_e = rscores[cand[:, 0], cand[:, 1]]
        kth = torch.topk(rscores.reshape(-1), top_k).values[-1]
        excuse = torch.minimum((s_e - score_thresh) / score_thresh,
                               torch.clamp((s_e - kth) / kth, min=0))
        if dets:
            e_box = corners[cand[:, 0]] + (cand[:, 1:2].float()
                                           * CLASS_OFFSET)
            iou = iou_matrix(e_box, shifted)                 # (E, D)
            short = torch.maximum(
                torch.clamp((iou_thresh - iou) / iou_thresh, min=0),
                torch.clamp((s_e[:, None] - scores[None]) / s_e[:, None],
                            min=0))
            excuse = torch.minimum(excuse, short.min(1).values)
        worst["cover_gap"] = max(worst["cover_gap"], float(excuse.max()))
    return {**worst, "overlap_pairs": float(overlap_pairs),
            "miss_share": counts["miss"] / max(counts["ref"], 1),
            "extra_share": counts["extra"] / max(counts["got"], 1)}


def _leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
               keep) -> Dict[str, float]:
    """Each leaf's gap of norms, |‖got‖ - ‖want‖|, over the larger of
    ‖want‖ and the median leaf's ‖want‖."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in
             want.items()}
    median = float(np.median(list(norms.values())))
    return {k: abs(float(torch.linalg.vector_norm(got[k].double()))
                   - norms[k]) / max(norms[k], median)
            for k in want if keep(k)}


def compare_train(program, ref) -> Dict[str, float]:
    """``program`` and ``ref``: (loss of each checked step, the first
    step's gradient of each leaf, each leaf's change over the checked
    steps). Leaves whose reference gradient is below a thousandth of the
    median leaf's (a bias that BN cancels, say) move by round-off alone
    and are left out of the leaf gaps."""
    (loss_p, grad_p, change_p), (loss_r, grad_r, change_r) = program, ref
    g = {k: float(torch.linalg.vector_norm(v.double()))
         for k, v in grad_r.items()}
    floor = 1e-3 * float(np.median(list(g.values())))

    def moving(k):
        return g[k] >= floor

    grad_p = {k: v.to(grad_r[k].device) for k, v in grad_p.items()}
    change_p = {k: v.to(change_r[k].device) for k, v in change_p.items()}
    out = {"loss_gap": max(abs(p - r) / abs(r)
                           for p, r in zip(loss_p, loss_r))}
    for name, got, want in (("grad", grad_p, grad_r),
                            ("change", change_p, change_r)):
        gaps = _leaf_gaps(got, want, moving)
        worst = max(gaps, key=gaps.get)
        print(f"compare: {name} gap worst leaf {worst} "
              f"({want[worst].numel()} values) {gaps[worst]!r}",
              file=sys.stderr)
        out[f"{name}_gap"] = gaps[worst]
        out[f"{name}_med"] = float(np.median(list(gaps.values())))
    return out
