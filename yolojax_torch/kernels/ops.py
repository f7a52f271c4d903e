"""The port's three hand kernels as PyTorch custom operators.

Each kernel is one ``torch.library.custom_op`` in the ``yolojax_torch``
namespace: its CPU implementation is the kernel's plain version, its CUDA
implementation launches the kernel (the ``ctypes`` launcher of its wrapper
module, on the current stream), and its fake implementation gives only the
output's shape and dtype. ``torch.export`` cannot trace a ``ctypes`` call,
but it keeps a custom operator as one node, so an exported serving
artifact (``yolojax_torch/serve``) carries the kernels themselves: it runs
them on the card and their plain versions on the CPU, as the live program
does. The wrappers (``postprocess/cuda_nms.py``, ``nn/cuda_stem.py``,
``quantize/cuda_int8.py``) check their arguments and call these operators;
the launch counters stay on the wrappers and count only real launches.

Importing this module registers the operators; it loads no CUDA library.
"""

from __future__ import annotations

import torch

from yolojax_torch.nn.stem import stem_fused_torch
from yolojax_torch.postprocess.nms import nms_greedy_torch
from yolojax_torch.quantize.int8_ops import int8_requant_torch


@torch.library.custom_op("yolojax_torch::nms_greedy", mutates_args=(),
                         device_types="cpu")
def nms_greedy(boxes: torch.Tensor, valid: torch.Tensor,
               iou_thresh: float) -> torch.Tensor:
    """Greedy NMS: boxes (N, K, 4) f32, valid (N, K) -> keep (N, K) bool."""
    return nms_greedy_torch(boxes, valid, iou_thresh)


@nms_greedy.register_kernel("cuda")
def _nms_greedy_cuda(boxes, valid, iou_thresh):
    from yolojax_torch.postprocess.cuda_nms import launch

    return launch(boxes, valid, iou_thresh)


@nms_greedy.register_fake
def _nms_greedy_fake(boxes, valid, iou_thresh):
    return valid.new_empty(valid.shape, dtype=torch.bool)


@torch.library.custom_op("yolojax_torch::stem_fused", mutates_args=(),
                         device_types="cpu")
def stem_fused(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Fused stem: x (N, H, W, 3) f32 -> (N, H/2, W/2, Co) bf16. ``w`` is
    conv0's kernel in the layout of x's device: the packed kernel ``wp``
    (3, 3, 12, 4*Co) on the CPU, its fragment-order copy ``wfrag``
    (16, 32) int32 on the card."""
    return stem_fused_torch(x, w, b)


@stem_fused.register_kernel("cuda")
def _stem_fused_cuda(x, w, b):
    from yolojax_torch.nn.cuda_stem import launch

    return launch(x, w, b)


@stem_fused.register_fake
def _stem_fused_fake(x, w, b):
    n, h, w_, _ = x.shape
    return x.new_empty((n, h // 2, w_ // 2, b.shape[0]), dtype=torch.bfloat16)


@torch.library.custom_op("yolojax_torch::int8_requant", mutates_args=(),
                         device_types="cpu")
def int8_requant(acc: torch.Tensor, m: torch.Tensor, b: torch.Tensor,
                 r: float, qmax: int, leaky: bool,
                 phases: int) -> torch.Tensor:
    """int32 sums (M, phases*C) -> int8 codes (M, C)."""
    return int8_requant_torch(acc, m, b, r, qmax, leaky, phases)


@int8_requant.register_kernel("cuda")
def _int8_requant_cuda(acc, m, b, r, qmax, leaky, phases):
    from yolojax_torch.quantize.cuda_int8 import launch

    return launch(acc, m, b, r, qmax, leaky, phases)


@int8_requant.register_fake
def _int8_requant_fake(acc, m, b, r, qmax, leaky, phases):
    return acc.new_empty((acc.shape[0], acc.shape[1] // phases),
                         dtype=torch.int8)
