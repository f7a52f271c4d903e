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

Only the inference forward is ported here, with the fused stem
(``nn/stem.py``: ``StemSpec`` / ``NoOpSpec``, weights in a
:class:`StemLayer`); train-mode BN and dropout and the int8 trunk come in
later slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

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
    """A spec list and its weights; ``forward`` is yolojax's eval-mode
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
                leaky_alpha: float = 0.1) -> torch.Tensor:
        """images (N, H, W, C) -> f32 output (NHWC, or (N, F) after a
        dense head). Conv outputs are stored in ``compute_dtype``; the
        bias/BN + leaky epilogue runs in f32 and is cast back."""
        x = images
        outputs = []
        for i, spec in enumerate(self.specs):
            tname = type(spec).__name__
            if tname == "StemSpec":  # fused conv0 + pool (nn/stem.py)
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
                y = conv2d(x, layer.w, spec.stride,
                           compute_dtype=compute_dtype).float()
                if spec.bn:
                    y = batch_norm(y, layer.scale, layer.bias, layer.mean,
                                   layer.var, eps=bn_eps)
                else:
                    y = y + layer.b.float()
                if spec.act == "leaky":
                    y = leaky_relu(y, leaky_alpha)
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
                y = y + layer.b.float()
                if spec.act == "leaky":
                    y = leaky_relu(y, leaky_alpha)
                x = y.to(compute_dtype)
            elif isinstance(spec, DropoutSpec):
                pass  # eval mode: identity
            else:
                raise TypeError(f"unknown layer spec: {spec!r}")
            outputs.append(x)
        return x.float()


def init_network(generator: torch.Generator, specs: Sequence[LayerSpec],
                 in_channels: int, input_hw: Tuple[int, int]) -> Network:
    """He-normal conv/dense kernels (leaky gain), unit BN, zero biases,
    as yolojax's ``init_network``; draws come from ``generator`` (on the
    CPU) and are not yolojax's random bits."""
    layers: Dict[str, nn.Module] = {}
    h, w = input_hw
    c = in_channels
    channel_hist = []  # per-spec output channels for RouteSpec
    hw_hist = []
    for i, spec in enumerate(specs):
        tname = type(spec).__name__
        if tname == "StemSpec":
            from yolojax_torch.nn.stem import pack_stem_kernel

            w0 = torch.randn((3, 3, c, spec.out), generator=generator)
            wp = pack_stem_kernel((w0 * math.sqrt(2.0 / (9 * c))).numpy())
            layers[_conv_name(i)] = StemLayer(torch.from_numpy(wp),
                                              torch.zeros(spec.out))
            c = spec.out
            h, w = h // 2, w // 2
        elif tname == "NoOpSpec":
            pass
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
            std = math.sqrt(2.0 / c)
            layers[_dense_name(i)] = DenseLayer(
                torch.randn((spec.out, c), generator=generator) * std,
                torch.zeros(spec.out))
            c = spec.out
        elif isinstance(spec, DropoutSpec):
            pass
        else:
            raise TypeError(f"unknown layer spec: {spec!r}")
        channel_hist.append(c)
        hw_hist.append((h, w))
    return Network(specs, layers)
