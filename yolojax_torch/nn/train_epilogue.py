"""The train-mode epilogue of a bf16 conv or dense layer as one autograd
Function over the hand kernels.

yolojax's train step (``yolojax/nn/layers.py::apply_network``,
``:397-420``, differentiated by ``jax.grad`` in
``yolojax/train/step.py:302``) normalises each BN conv's bf16 product with
its batch's mean and biased variance (two passes of the f32 upcast),
applies leaky and casts back to bf16, and XLA fuses that and its VJP.
:class:`TrainEpilogue` computes the same as kernels
(``nn/cuda_bn_train.py``, ``nn/cuda_epilogue.py``; their plain versions in
``nn/layers.py`` on the CPU):

* forward, BN mode: ``m = Σy / N``, ``v = Σ(y - m)² / N`` (two
  ``bn_channel_sums``), ``rstd = rsqrt(v + eps)`` and ``bn_affine``'s
  ``(inv, shift)`` in torch, once a channel, then ``conv_epilogue`` (the
  eval-mode kernel: normalise, leaky, bf16);
* backward, BN mode: ``epilogue_grad_sums`` gives Σdz and Σdz·x̂ (dz the
  output's gradient through leaky, x̂ = (y - m) * rstd), which are the
  gradients of BN's bias and scale; ``epilogue_grad_apply`` gives
  ``dy = bf16(inv * (dz - Σdz/N - x̂ Σdz·x̂/N))``;
* bias mode (the head conv, YOLOv1's convs and dense layers): forward
  ``conv_epilogue`` with the bias; backward Σdz (the bias's gradient) and
  ``dy = bf16(dz)``.

Only ``y`` (bf16) and per-channel vectors are saved for the backward. Over
a mesh's data ranks (``group``) the per-channel sums and the count are
all-reduced between the passes, forward and backward, so the statistics
and ``dy`` are the global batch's; the parameters' gradients stay this
rank's own sums, as autograd of the plain ops gives them (the step
averages them over the ranks). ``m`` and ``v`` come back detached, for the
running statistics.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from yolojax_torch.nn import cuda_bn_train, cuda_epilogue
from yolojax_torch.nn.layers import _upcast


class TrainEpilogue(torch.autograd.Function):
    """``apply(y, bias, scale, leaky, alpha, eps, group)``: BN mode when
    ``scale`` is given (``bias`` is BN's bias; returns ``(x, m, v)``),
    bias mode when it is None (``bias`` is the layer's; returns ``x``)."""

    @staticmethod
    def forward(ctx, y, bias, scale, leaky, alpha, eps, group):
        ctx.leaky, ctx.alpha, ctx.group = leaky, alpha, group
        if scale is None:
            shift = _upcast(bias)
            ctx.save_for_backward(y, shift)
            return cuda_epilogue.conv_epilogue_cuda(y, shift, leaky=leaky,
                                                    alpha=alpha)
        n = y.numel() // y.shape[-1]
        s = cuda_bn_train.bn_channel_sums_cuda(y)
        if group is not None:
            s = torch.cat([s, torch.full((1,), float(n), device=y.device)])
            dist.all_reduce(s, group=group)
            s, n = s[:-1], s[-1]
        m = s / n
        s = cuda_bn_train.bn_channel_sums_cuda(y, m)
        if group is not None:
            dist.all_reduce(s, group=group)
        v = s / n
        rstd = torch.rsqrt(v + eps)
        inv = rstd * _upcast(scale)  # bn_affine's operation order
        shift = _upcast(bias) - m * inv
        x = cuda_epilogue.conv_epilogue_cuda(y, shift, inv, leaky=leaky,
                                             alpha=alpha)
        ctx.n = n
        ctx.save_for_backward(y, shift, inv, m, rstd)
        ctx.mark_non_differentiable(m, v)
        return x, m, v

    @staticmethod
    def backward(ctx, gx, *_):
        g = cuda_bn_train.rows_of_grad(gx)
        saved = ctx.saved_tensors  # once: remat recomputes them on access
        if len(saved) == 2:  # bias mode
            y, shift = saved
            sums = cuda_bn_train.epilogue_grad_sums_cuda(
                g, y, None, shift, None, None, leaky=ctx.leaky,
                alpha=ctx.alpha)
            dy = cuda_bn_train.epilogue_grad_apply_cuda(
                g, y, None, shift, None, None, None, None, leaky=ctx.leaky,
                alpha=ctx.alpha)
            return dy, sums[0], None, None, None, None, None
        y, shift, inv, m, rstd = saved
        sums = cuda_bn_train.epilogue_grad_sums_cuda(
            g, y, inv, shift, m, rstd, leaky=ctx.leaky, alpha=ctx.alpha)
        total = sums
        if ctx.group is not None:  # the global batch's means
            total = sums.clone()
            dist.all_reduce(total, group=ctx.group)
        dy = cuda_bn_train.epilogue_grad_apply_cuda(
            g, y, inv, shift, m, rstd, total[0] / ctx.n, total[1] / ctx.n,
            leaky=ctx.leaky, alpha=ctx.alpha)
        return dy, sums[0], sums[1], None, None, None, None


def bn_train_epilogue(y: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, *, leaky: bool, alpha: float = 0.1,
                      eps: float = 1e-5, group=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A BN conv's train-mode epilogue: y (..., C) bf16 -> (x bf16, batch
    mean, biased batch variance); ``group`` the data ranks' group."""
    return TrainEpilogue.apply(y, bias, scale, leaky, alpha, eps, group)


def bias_train_epilogue(y: torch.Tensor, b: torch.Tensor, *, leaky: bool,
                        alpha: float = 0.1) -> torch.Tensor:
    """A bias layer's train-mode epilogue: y (..., C) bf16 -> x bf16."""
    return TrainEpilogue.apply(y, b, None, leaky, alpha, 0.0, None)
