"""The port's hand kernels as PyTorch custom operators.

Each kernel is one ``torch.library.custom_op`` in the ``yolojax_torch``
namespace: its CPU implementation is the kernel's plain version, its CUDA
implementation launches the kernel (the ``ctypes`` launcher of its wrapper
module, on the current stream), and its fake implementation gives only the
output's shape and dtype. ``torch.export`` cannot trace a ``ctypes`` call,
but it keeps a custom operator as one node, so an exported serving
artifact (``yolojax_torch/serve``) carries the kernels themselves: it runs
them on the card and their plain versions on the CPU, as the live program
does. The wrappers (``postprocess/cuda_nms.py``, ``nn/cuda_stem.py``,
``quantize/cuda_int8.py``, ``nn/cuda_epilogue.py``,
``nn/cuda_bn_train.py``, ``postprocess/cuda_topk.py``) check their
arguments and call these operators; the launch counters stay on the
wrappers and count only real launches.

Importing this module registers the operators; it loads no CUDA library.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from yolojax_torch.nn.layers import (
    _out_dtype,
    bn_channel_sums_torch,
    conv_epilogue_torch,
    epilogue_grad_apply_torch,
    epilogue_grad_sums_torch,
)
from yolojax_torch.nn.stem import stem_fused_torch
from yolojax_torch.postprocess.nms import nms_greedy_torch, topk_select_torch
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


@torch.library.custom_op("yolojax_torch::topk_select", mutates_args=(),
                         device_types="cpu")
def topk_select(scores: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-K: scores (N, L) f32 -> (values (N, k) f32, indices
    (N, k) int64), a stable descending sort's first k columns. On the CPU
    the kernel's twin gives the sort's bits, and in less time than the
    sort at YOLOv3's rows (PERF.md §6)."""
    return topk_select_torch(scores, k)


@topk_select.register_kernel("cuda")
def _topk_select_cuda(scores, k):
    from yolojax_torch.postprocess.cuda_topk import launch

    return launch(scores, k)


@topk_select.register_fake
def _topk_select_fake(scores, k):
    n = scores.shape[0]
    return (scores.new_empty((n, k)),
            scores.new_empty((n, k), dtype=torch.int64))


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


@torch.library.custom_op("yolojax_torch::conv_epilogue", mutates_args=(),
                         device_types="cpu")
def conv_epilogue(y: torch.Tensor, b: torch.Tensor,
                  scale: Optional[torch.Tensor], leaky: bool,
                  alpha: float, r: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """bf16 conv/dense output (..., C) -> f32 + bias (or * scale + bias)
    -> leaky -> bf16 (..., C), plus the residual ``r`` after the cast."""
    return conv_epilogue_torch(y, b, scale, r, leaky=leaky, alpha=alpha)


@conv_epilogue.register_kernel("cuda")
def _conv_epilogue_cuda(y, b, scale, leaky, alpha, r=None):
    from yolojax_torch.nn.cuda_epilogue import launch

    return launch(y, b, scale, leaky, alpha, r)


@conv_epilogue.register_fake
def _conv_epilogue_fake(y, b, scale, leaky, alpha, r=None):
    return y.new_empty(y.shape, dtype=_out_dtype(y))


# the train-mode epilogue (csrc/bn_train.cu): y bf16 (float64 on the CPU for
# a gradcheck), f32 per-channel vectors


def _sums_dtype(y: torch.Tensor) -> torch.dtype:
    return torch.float64 if y.dtype == torch.float64 else torch.float32


@torch.library.custom_op("yolojax_torch::bn_channel_sums", mutates_args=(),
                         device_types="cpu")
def bn_channel_sums(y: torch.Tensor, m: Optional[torch.Tensor]) -> torch.Tensor:
    """y (..., C) -> (C,) f32: Σy, or Σ(y - m)² given the mean."""
    return bn_channel_sums_torch(y, m)


@bn_channel_sums.register_kernel("cuda")
def _bn_channel_sums_cuda(y, m):
    from yolojax_torch.nn.cuda_bn_train import launch_sums

    return launch_sums(y, m)


@bn_channel_sums.register_fake
def _bn_channel_sums_fake(y, m):
    return y.new_empty((y.shape[-1],), dtype=_sums_dtype(y))


@torch.library.custom_op("yolojax_torch::epilogue_grad_sums", mutates_args=(),
                         device_types="cpu")
def epilogue_grad_sums(g: torch.Tensor, y: torch.Tensor,
                       inv: Optional[torch.Tensor], shift: torch.Tensor,
                       m: Optional[torch.Tensor], rstd: Optional[torch.Tensor],
                       leaky: bool, alpha: float) -> torch.Tensor:
    """(Σdz, Σdz·x̂) (2, C) in BN mode, (Σdz,) (1, C) without ``inv``."""
    return epilogue_grad_sums_torch(g, y, inv, shift, m, rstd, leaky, alpha)


@epilogue_grad_sums.register_kernel("cuda")
def _epilogue_grad_sums_cuda(g, y, inv, shift, m, rstd, leaky, alpha):
    from yolojax_torch.nn.cuda_bn_train import launch_grad_sums

    return launch_grad_sums(g, y, inv, shift, m, rstd, leaky, alpha)


@epilogue_grad_sums.register_fake
def _epilogue_grad_sums_fake(g, y, inv, shift, m, rstd, leaky, alpha):
    return y.new_empty((1 if inv is None else 2, y.shape[-1]),
                       dtype=_sums_dtype(y))


@torch.library.custom_op("yolojax_torch::epilogue_grad_apply", mutates_args=(),
                         device_types="cpu")
def epilogue_grad_apply(g: torch.Tensor, y: torch.Tensor,
                        inv: Optional[torch.Tensor], shift: torch.Tensor,
                        m: Optional[torch.Tensor], rstd: Optional[torch.Tensor],
                        mdz: Optional[torch.Tensor],
                        mdzx: Optional[torch.Tensor], leaky: bool,
                        alpha: float) -> torch.Tensor:
    """dy (..., C) bf16 of the train-mode epilogue's input."""
    return epilogue_grad_apply_torch(g, y, inv, shift, m, rstd, mdz, mdzx,
                                     leaky, alpha)


@epilogue_grad_apply.register_kernel("cuda")
def _epilogue_grad_apply_cuda(g, y, inv, shift, m, rstd, mdz, mdzx, leaky,
                              alpha):
    from yolojax_torch.nn.cuda_bn_train import launch_grad_apply

    return launch_grad_apply(g, y, inv, shift, m, rstd, mdz, mdzx, leaky,
                             alpha)


@epilogue_grad_apply.register_fake
def _epilogue_grad_apply_fake(g, y, inv, shift, m, rstd, mdz, mdzx, leaky,
                              alpha):
    return y.new_empty(y.shape, dtype=_out_dtype(y))
