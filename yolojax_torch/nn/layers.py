"""Layer specs and the eval-mode forward pass, in PyTorch.

Port of ``yolojax/nn/layers.py``. A network is still a flat tuple of layer
*specs*; :class:`Network` holds one submodule per conv/dense spec
(``conv_<i>`` / ``dense_<i>``, the names yolojax's parameter pytrees use)
and runs the specs in order.

Layouts follow yolojax: activations are NHWC between layers. A conv sees
``x.permute(0, 3, 1, 2)``, which for a contiguous NHWC tensor is already a
channels_last NCHW view, and its output is permuted back, so no layer
copies between layouts. Conv kernels are stored OIHW (PyTorch's order);
``yolojax_torch.convert.interchange`` converts from and to yolojax's HWIO.

The forward runs in eval mode (running BN statistics, the fused stem of
``nn/stem.py``: ``StemSpec`` / ``NoOpSpec``, weights in a
:class:`StemLayer`) or in train mode (batch BN statistics, dropout); the
int8 trunk comes in a later slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolojax_torch.parallel.collectives import (
    all_reduce_sum,
    copy_to_model,
    gather_from_model,
)

# ---------------------------------------------------------------------------
# Layer specs (copied from yolojax/nn/layers.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """2-D convolution, optionally fused with BN + activation."""

    out: int
    ksize: int
    stride: int = 1
    bn: bool = True
    act: str = "leaky"  # "leaky" | "linear"


@dataclasses.dataclass(frozen=True)
class MaxPoolSpec:
    size: int = 2
    stride: int = 2


@dataclasses.dataclass(frozen=True)
class RouteSpec:
    """Concatenate earlier layer outputs along channels (Darknet 'route').

    ``layers`` holds relative (negative) or absolute indices into the
    per-spec output list, exactly like a Darknet cfg route layer.
    """

    layers: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class ReorgSpec:
    """Space-to-depth passthrough (YOLOv2 'reorg', stride 2)."""

    stride: int = 2


@dataclasses.dataclass(frozen=True)
class FlattenSpec:
    """Flatten NHWC -> (N, C*H*W) in NCHW order (Darknet 'connected' input
    order, so imported FC weights line up)."""


@dataclasses.dataclass(frozen=True)
class DenseSpec:
    out: int
    act: str = "leaky"


@dataclasses.dataclass(frozen=True)
class DropoutSpec:
    rate: float = 0.5


LayerSpec = Any  # union of the dataclasses above


# ---------------------------------------------------------------------------
# Primitive ops (NHWC in, NHWC out)
# ---------------------------------------------------------------------------


def _darknet_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """Explicit (lo, hi) padding reproducing Darknet's conv arithmetic:
    pad ``k // 2`` and floor. For YOLOv1's strided convs this is
    asymmetric, which ``F.conv2d``'s symmetric ``padding=`` cannot say."""
    pad_lo = kernel // 2
    out = (size + 2 * pad_lo - kernel) // stride + 1
    pad_hi = max((out - 1) * stride + kernel - size - pad_lo, 0)
    return pad_lo, pad_hi


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, *,
           compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """NHWC x OIHW conv with Darknet padding; the output stays in
    ``compute_dtype`` (the rounding point of yolojax's ``conv2d``)."""
    pad_h = _darknet_padding(x.shape[1], w.shape[2], stride)
    pad_w = _darknet_padding(x.shape[2], w.shape[3], stride)
    x = x.to(compute_dtype)
    if pad_h[0] == pad_h[1] and pad_w[0] == pad_w[1]:
        padding = (pad_h[0], pad_w[0])
    else:
        x = F.pad(x, (0, 0) + pad_w + pad_h)
        padding = (0, 0)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(compute_dtype), stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """Inference-form BN in f32: y = x * inv + (bias - mean * inv) with
    inv = rsqrt(var + eps) * scale, yolojax's operation order."""
    inv = torch.rsqrt(var.float() + eps) * scale.float()
    return x.float() * inv + (bias.float() - mean.float() * inv)


def leaky_relu(x: torch.Tensor, alpha: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def max_pool(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """Max pool with Darknet padding: SAME-style, split low/high, -inf
    fill. Tiny-YOLOv2's ``MaxPoolSpec(2, 1)`` pads (0, 1)."""
    h, w = x.shape[1], x.shape[2]
    total_h = max((math.ceil(h / stride) - 1) * stride + size - h, 0)
    total_w = max((math.ceil(w / stride) - 1) * stride + size - w, 0)
    if total_h or total_w:
        x = F.pad(x, (0, 0, total_w // 2, total_w - total_w // 2,
                      total_h // 2, total_h - total_h // 2),
                  value=-math.inf)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), size, stride)
    return y.permute(0, 2, 3, 1)


def space_to_depth(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Darknet 'reorg' (tf.space_to_depth): (N, H, W, C) ->
    (N, H/s, W/s, s*s*C), output channel (i*s + j)*C + c.
    ``F.pixel_unshuffle`` orders channels the other way."""
    n, h, w, c = x.shape
    s = stride
    x = x.reshape(n, h // s, s, w // s, s, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // s, w // s, c * s * s)


def _batch_moments(y: torch.Tensor, mesh=None):
    """Per-channel mean and biased variance of NHWC ``y`` over (N, H, W):
    two passes, the mean first. Over a mesh's data ranks the sums and the
    count are all-reduced (differentiably), so the moments are the global
    batch's."""
    if mesh is None:
        m = y.mean(dim=(0, 1, 2))
        return m, torch.square(y - m).mean(dim=(0, 1, 2))
    count = torch.full((1,), float(y.shape[0] * y.shape[1] * y.shape[2]),
                       device=y.device)
    s = all_reduce_sum(torch.cat([y.sum(dim=(0, 1, 2)), count]),
                       mesh.data_group)
    n = s[-1]
    m = s[:-1] / n
    v = all_reduce_sum(torch.square(y - m).sum(dim=(0, 1, 2)),
                       mesh.data_group) / n
    return m, v


# ---------------------------------------------------------------------------
# Network
# ---------------------------------------------------------------------------


def _conv_name(i: int) -> str:
    return f"conv_{i}"


def _dense_name(i: int) -> str:
    return f"dense_{i}"


class ConvLayer(nn.Module):
    """Weights of one ConvSpec: ``w`` (O, I, kh, kw) plus either a bias
    ``b`` or BN ``scale``/``bias`` parameters and ``mean``/``var``
    running statistics (buffers)."""

    def __init__(self, w: torch.Tensor, *, b: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None,
                 bias: Optional[torch.Tensor] = None,
                 mean: Optional[torch.Tensor] = None,
                 var: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = nn.Parameter(w)
        if b is not None:
            self.b = nn.Parameter(b)
        else:
            self.scale = nn.Parameter(scale)
            self.bias = nn.Parameter(bias)
            self.register_buffer("mean", mean)
            self.register_buffer("var", var)


class StemLayer(nn.Module):
    """Weights of the fused stem (``StemSpec``): the packed kernel ``wp``
    (3, 3, 4*Ci, 4*Co), laid out HWIO as yolojax's ``pack_stem_kernel``
    lays it out, and the folded bias ``b`` (Co,). ``wfrag``, the CUDA
    kernel's B operand in its per-lane fragment order
    (``nn/stem.py::stem_mma_operand``), is made from ``wp`` once, here, and
    moves with the module as a buffer that is not saved (None unless conv0
    is 3 -> 32, the kernel's shape)."""

    def __init__(self, wp: torch.Tensor, b: torch.Tensor):
        super().__init__()
        from yolojax_torch.nn.stem import stem_mma_operand, unpack_stem_kernel

        self.wp = nn.Parameter(wp)
        self.b = nn.Parameter(b)
        w0 = unpack_stem_kernel(wp.detach().float())
        self.register_buffer(
            "wfrag",
            stem_mma_operand(w0) if tuple(w0.shape) == (3, 3, 3, 32) else None,
            persistent=False)


class DenseLayer(nn.Module):
    """Weights of one DenseSpec: ``w`` (out, in) as ``F.linear`` takes
    it, and ``b`` (out,)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class Network(nn.Module):
    """A spec list and its weights; ``forward`` is yolojax's
    ``apply_network``."""

    def __init__(self, specs: Sequence[LayerSpec],
                 layers: Dict[str, nn.Module]):
        super().__init__()
        self.specs = tuple(specs)
        for name, layer in layers.items():
            self.add_module(name, layer)

    def forward(self, images: torch.Tensor, *,
                compute_dtype: torch.dtype = torch.bfloat16,
                bn_eps: float = 1e-5,
                leaky_alpha: float = 0.1,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                bn_momentum: float = 0.99,
                mesh=None):
        """images (N, H, W, C) -> f32 output (NHWC, or (N, F) after a
        dense head). Conv outputs are stored in ``compute_dtype``; the
        bias/BN + leaky epilogue runs in f32 and is cast back.

        Eval mode returns the output and leaves the BN buffers alone.
        Train mode returns ``(output, new_bn_state)``: BN normalises with
        the batch's mean and biased variance (two passes in f32, gradients
        flow through both), and ``new_bn_state`` maps each BN conv's name
        to its running ``(mean, var)`` moved to ``run * bn_momentum +
        batch * (1 - bn_momentum)`` (detached; the caller stores them).
        ``F.batch_norm(training=True)`` is not used: it would move the
        running variance with the unbiased estimate, and its ``momentum``
        means 1 - ``bn_momentum``. Dropout keeps each unit with
        probability 1 - rate, drawn from ``generator``, and scales the kept
        ones by 1 / (1 - rate).

        ``mesh`` (``parallel/mesh.py``): this rank's part of a step on a
        mesh. Over data ranks, train-mode BN takes the global batch's
        statistics (per-channel sums and counts all-reduced, with their
        gradients) and dropout draws the global batch's mask and keeps
        this rank's rows. Over model ranks, a conv whose kernel holds a
        slice of its output channels (``parallel/sharding.py``) computes
        that slice, and the slices are gathered after its epilogue."""
        dp = mesh is not None and mesh.data > 1
        tp = mesh is not None and mesh.model > 1
        x = images
        outputs = []
        new_state: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        for i, spec in enumerate(self.specs):
            tname = type(spec).__name__
            if tname == "StemSpec":  # fused conv0 + pool (nn/stem.py)
                if train:
                    raise ValueError("train mode needs the unfused model: the "
                                     "fused stem holds BN-folded weights")
                layer = getattr(self, _conv_name(i))
                if spec.impl == "xla":
                    from yolojax_torch.nn.stem import stem_forward

                    x = stem_forward(x, layer.wp, layer.b,
                                     compute_dtype=compute_dtype)
                else:  # "pallas" | "auto": the CUDA kernel, bf16 NHWC out
                    from yolojax_torch.nn.cuda_stem import stem_fused_cuda

                    x = stem_fused_cuda(x, layer.wp, layer.b, wfrag=layer.wfrag)
            elif tname == "NoOpSpec":
                pass
            elif isinstance(spec, ConvSpec):
                layer = getattr(self, _conv_name(i))
                tp_layer = tp and layer.w.shape[0] != spec.out
                if tp_layer:
                    x = copy_to_model(x, mesh)
                y = conv2d(x, layer.w, spec.stride,
                           compute_dtype=compute_dtype).float()
                if spec.bn:
                    if train:
                        m, v = _batch_moments(y, mesh if dp else None)
                        new_state[_conv_name(i)] = (
                            layer.mean * bn_momentum
                            + m.detach() * (1 - bn_momentum),
                            layer.var * bn_momentum
                            + v.detach() * (1 - bn_momentum))
                    else:
                        m, v = layer.mean, layer.var
                    y = batch_norm(y, layer.scale, layer.bias, m, v,
                                   eps=bn_eps)
                else:
                    y = y + layer.b.float()
                if spec.act == "leaky":
                    y = leaky_relu(y, leaky_alpha)
                if tp_layer:  # gathered in f32: gloo takes no bf16 sums
                    y = gather_from_model(y, mesh)
                x = y.to(compute_dtype)
            elif isinstance(spec, MaxPoolSpec):
                x = max_pool(x, spec.size, spec.stride)
            elif isinstance(spec, ReorgSpec):
                x = space_to_depth(x, spec.stride)
            elif isinstance(spec, RouteSpec):
                parts = [outputs[r if r >= 0 else i + r] for r in spec.layers]
                x = torch.cat(parts, dim=-1)
            elif isinstance(spec, FlattenSpec):
                x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
            elif isinstance(spec, DenseSpec):
                layer = getattr(self, _dense_name(i))
                y = F.linear(x.to(compute_dtype),
                             layer.w.to(compute_dtype)).float()
                b = layer.b
                if tp and b.shape[0] != spec.out:  # a long bias is split
                    b = gather_from_model(b, mesh)
                y = y + b.float()
                if spec.act == "leaky":
                    y = leaky_relu(y, leaky_alpha)
                x = y.to(compute_dtype)
            elif isinstance(spec, DropoutSpec):
                if train:  # eval mode: identity
                    if generator is None:
                        raise ValueError("dropout in train mode needs a "
                                         "generator")
                    shape, rows = x.shape, slice(None)
                    if dp:  # the global batch's mask, this rank's rows
                        n = x.shape[0]
                        shape = (n * mesh.data,) + tuple(x.shape[1:])
                        rows = slice(mesh.data_index * n,
                                     (mesh.data_index + 1) * n)
                    keep = torch.rand(shape, generator=generator,
                                      device=x.device)[rows] < 1.0 - spec.rate
                    x = torch.where(keep, x / (1.0 - spec.rate),
                                    torch.zeros((), dtype=x.dtype,
                                                device=x.device))
            else:
                raise TypeError(f"unknown layer spec: {spec!r}")
            outputs.append(x)
        if train:
            return x.float(), new_state
        return x.float()

    def load_bn_state(self, new_state: Dict[str, Tuple[torch.Tensor,
                                                       torch.Tensor]]):
        """Store a train-mode forward's running statistics in the buffers."""
        with torch.no_grad():
            for name, (mean, var) in new_state.items():
                layer = getattr(self, name)
                layer.mean.copy_(mean)
                layer.var.copy_(var)


def _shape_walk(specs: Sequence[LayerSpec], in_channels: int,
                input_hw: Tuple[int, int]):
    """Yield ``(index, spec, input channels)`` for each spec, following the
    channel count and spatial size through the network as the forward
    changes them (Darknet conv arithmetic, ceil pools, routes, reorg, the
    flatten before a dense layer)."""
    h, w = input_hw
    c = in_channels
    channel_hist = []  # per-spec output channels for RouteSpec
    hw_hist = []
    for i, spec in enumerate(specs):
        yield i, spec, c
        tname = type(spec).__name__
        if tname == "StemSpec":
            c = spec.out
            h, w = h // 2, w // 2
        elif tname == "NoOpSpec":
            pass
        elif isinstance(spec, ConvSpec):
            c = spec.out
            h = (h + 2 * (spec.ksize // 2) - spec.ksize) // spec.stride + 1
            w = (w + 2 * (spec.ksize // 2) - spec.ksize) // spec.stride + 1
        elif isinstance(spec, MaxPoolSpec):
            h = math.ceil(h / spec.stride)
            w = math.ceil(w / spec.stride)
        elif isinstance(spec, ReorgSpec):
            c = c * spec.stride * spec.stride
            h //= spec.stride
            w //= spec.stride
        elif isinstance(spec, RouteSpec):
            c = sum(channel_hist[r if r >= 0 else i + r] for r in spec.layers)
            r0 = spec.layers[0]
            h, w = hw_hist[r0 if r0 >= 0 else i + r0]
        elif isinstance(spec, FlattenSpec):
            c = c * h * w
            h = w = 1
        elif isinstance(spec, DenseSpec):
            c = spec.out
        elif not isinstance(spec, DropoutSpec):
            raise TypeError(f"unknown layer spec: {spec!r}")
        channel_hist.append(c)
        hw_hist.append((h, w))


def weight_shapes(specs: Sequence[LayerSpec], in_channels: int,
                  input_hw: Tuple[int, int]) -> Dict[str, Tuple[int, ...]]:
    """The kernel shape of each conv (``conv_<i>``: OIHW) and dense
    (``dense_<i>``: (out, in)) layer, without building the network; a
    dense layer's input size depends on ``input_hw`` through the
    flatten."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    for i, spec, c in _shape_walk(specs, in_channels, input_hw):
        if isinstance(spec, ConvSpec):
            shapes[_conv_name(i)] = (spec.out, c, spec.ksize, spec.ksize)
        elif isinstance(spec, DenseSpec):
            shapes[_dense_name(i)] = (spec.out, c)
    return shapes


def init_network(generator: torch.Generator, specs: Sequence[LayerSpec],
                 in_channels: int, input_hw: Tuple[int, int]) -> Network:
    """He-normal conv/dense kernels (leaky gain), unit BN, zero biases,
    as yolojax's ``init_network``; draws come from ``generator`` (on the
    CPU) and are not yolojax's random bits."""
    layers: Dict[str, nn.Module] = {}
    for i, spec, c in _shape_walk(specs, in_channels, input_hw):
        if type(spec).__name__ == "StemSpec":
            from yolojax_torch.nn.stem import pack_stem_kernel

            w0 = torch.randn((3, 3, c, spec.out), generator=generator)
            wp = pack_stem_kernel((w0 * math.sqrt(2.0 / (9 * c))).numpy())
            layers[_conv_name(i)] = StemLayer(torch.from_numpy(wp),
                                              torch.zeros(spec.out))
        elif isinstance(spec, ConvSpec):
            std = math.sqrt(2.0 / (spec.ksize * spec.ksize * c))
            wt = torch.randn((spec.out, c, spec.ksize, spec.ksize),
                             generator=generator) * std
            if spec.bn:
                layers[_conv_name(i)] = ConvLayer(
                    wt, scale=torch.ones(spec.out), bias=torch.zeros(spec.out),
                    mean=torch.zeros(spec.out), var=torch.ones(spec.out))
            else:
                layers[_conv_name(i)] = ConvLayer(wt, b=torch.zeros(spec.out))
        elif isinstance(spec, DenseSpec):
            std = math.sqrt(2.0 / c)
            layers[_dense_name(i)] = DenseLayer(
                torch.randn((spec.out, c), generator=generator) * std,
                torch.zeros(spec.out))
    return Network(specs, layers)
