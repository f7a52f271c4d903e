"""The collectives of a data- and tensor-parallel step, with their
gradients.

Under a jitted yolojax step XLA inserts these from the shardings; the port
calls them where the step needs them:

* :func:`all_reduce_sum`: a sum over a group whose backward is the same
  sum of the gradients (``torch.distributed.nn.functional.all_reduce``):
  train-mode BN sums its per-channel statistics over the data ranks with
  it, so the gradient through the statistics crosses ranks;
* :func:`copy_to_model` / :func:`gather_from_model`: the two ends of a
  tensor-parallel conv. The input is replicated over the model ranks and
  each computes its slice of the output channels: the input's gradient is
  the sum of every rank's part (``copy_to_model``'s backward), and the
  gathered output is used identically on every model rank, so its gradient
  is this rank's slice of the gradient, not the reduce-scatter sum that
  ``torch.distributed.nn.functional.all_gather`` would take (which would
  multiply it by ``model``).

The flat helpers move many tensors in one collective, in a fixed order.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, size):
        ctx.index, ctx.width = index, x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.width
        return grad[..., lo: lo + ctx.width].contiguous(), None, None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; differentiable."""
    return _AllReduceSum.apply(x, group)


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Identity; the gradient sums over the model ranks."""
    return _CopyToModel.apply(x, mesh.model_group)


def gather_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every model rank's last-dim slice, concatenated in rank order; the
    gradient is this rank's slice."""
    return _GatherFromModel.apply(x, mesh.model_group, mesh.model_index,
                                  mesh.model)


def flat_all_reduce(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Sum each tensor over ``group`` in one collective (f32)."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at: at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def flat_gather(tensors: Sequence[torch.Tensor], dims: Sequence[int], group,
                size: int) -> List[torch.Tensor]:
    """Each tensor with every rank's copy concatenated along its dim in
    rank order, in one collective. Every rank's tensors have the same
    shapes."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors])
    parts = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(parts, flat, group=group)
    out, at = [], 0
    for t, d in zip(tensors, dims):
        n = t.numel()
        out.append(torch.cat([p[at: at + n].view(t.shape) for p in parts],
                             dim=d))
        at += n
    return out
