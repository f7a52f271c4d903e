"""The serving program: forward + decode + top-K + NMS on the device.

Port of ``make_infer_fn`` from ``yolojax/eval/evaluator.py`` (BASELINE
config 2). The int8 trunk (``qm``) and the mAP evaluation come in later
slices.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from yolojax_torch.models import Model
from yolojax_torch.nn.layers import Network
from yolojax_torch.postprocess.nms import postprocess_v1, postprocess_v2

# The eval protocol's score floor: low enough to keep the PR tail mAP/AR
# integrate over.
EVAL_SCORE_THRESH = 0.005


def make_infer_fn(model: Model, *, score_thresh: float, iou_thresh: float,
                  top_k: int, use_pallas: str = "auto",
                  candidates: str = "auto",
                  compute_dtype: torch.dtype = torch.bfloat16
                  ) -> Callable[[Network, torch.Tensor], Dict[str, torch.Tensor]]:
    """-> infer(net, images) -> {boxes, scores, classes, keep}, all fixed
    shape, on the images' device. images: (N, H, W, 3) in [0, 1]."""

    @torch.inference_mode()
    def infer(net: Network, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        head = model.apply(net, images, compute_dtype=compute_dtype)
        if model.kind == "v2":
            return postprocess_v2(
                head, model.anchors, score_thresh=score_thresh,
                iou_thresh=iou_thresh, top_k=top_k, use_pallas=use_pallas,
                candidates=candidates,
            )
        return postprocess_v1(
            head, model.grid, model.boxes_per_cell, model.num_classes,
            score_thresh=score_thresh, iou_thresh=iou_thresh, top_k=top_k,
            use_pallas=use_pallas, candidates=candidates,
        )

    return infer
