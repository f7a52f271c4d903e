"""Plain float32 reference of the YOLOv2 family, built from a
configuration file's layer list (``benchmark/configs/<name>.json``, a
transcription of the published Darknet cfg).

Plain PyTorch: NCHW, ``F.conv2d`` in float32 with TF32 off (the caller
sets the backend flags, see :func:`float32_exact`), no kernels of the
program, nothing made by the program. Departures from the Darknet
description, all shared with the program under test:

* BN is folded into the convolution at eps 1e-5 (Darknet normalises with
  1e-6);
* reorg is space-to-depth with output channel (i*2 + j)*C + c, as
  TensorFlow's ``space_to_depth``; Darknet's reorg lays the same values
  out in another channel order, which random weights cannot tell apart.

``round_operands="fp8"`` is the control: every convolution's input and
kernel rounded to float8 e4m3 (one scale a tensor, amax onto 448) before
the float32 product, the precision below the bfloat16 the serving program
states.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]

FP8_MAX = 448.0


@contextlib.contextmanager
def float32_exact():
    """float32 products without TF32 (cuBLAS and cuDNN), restored after."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def conv_layers(config: dict) -> List[int]:
    return [i for i, l in enumerate(config["layers"]) if l["type"] == "conv"]


def fold(config: dict, weights: Weights, eps: float = 1e-5) -> Weights:
    """BN folded into each conv, in float64, rounded to float32:
    w' = w * scale / sqrt(var + eps), b' = bias - mean * scale / sqrt(var
    + eps). Keys ``conv_<i>.w`` (OIHW) and ``conv_<i>.b``."""
    out: Weights = {}
    for i in conv_layers(config):
        name = f"conv_{i}"
        w = weights[f"{name}.w"].double()
        if config["layers"][i]["bn"]:
            inv = (weights[f"{name}.scale"].double()
                   / torch.sqrt(weights[f"{name}.var"].double() + eps))
            b = (weights[f"{name}.bias"].double()
                 - weights[f"{name}.mean"].double() * inv)
            w = w * inv[:, None, None, None]
        else:
            b = weights[f"{name}.b"].double()
        out[f"{name}.w"] = w.float()
        out[f"{name}.b"] = b.float()
    return out


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 at one scale (amax onto 448), back in f32."""
    amax = t.abs().max().clamp(min=1e-12)
    s = amax / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _maxpool(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """Darknet's maxpool: size - 1 of padding after the last row and
    column (never read as a maximum), out = (h - 1) // stride + 1."""
    if size > 1:
        x = F.pad(x, (0, size - 1, 0, size - 1), value=-math.inf)
    return F.max_pool2d(x, size, stride)


def _reorg(x: torch.Tensor, s: int) -> torch.Tensor:
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, s * s * c, h // s, w // s)


def forward(config: dict, folded: Weights, images: torch.Tensor, *,
            round_operands: Optional[str] = None) -> torch.Tensor:
    """images (N, H, W, 3) float32 in [0, 1] -> the raw head (N, h, w, A,
    5 + C) in float32."""
    alpha = float(config.get("leaky_alpha", 0.1))
    x = images.float().permute(0, 3, 1, 2)
    outputs: List[torch.Tensor] = []
    for i, layer in enumerate(config["layers"]):
        kind = layer["type"]
        if kind == "conv":
            w, b = folded[f"conv_{i}.w"], folded[f"conv_{i}.b"]
            if round_operands == "fp8":
                x, w = fp8_round(x), fp8_round(w)
            elif round_operands is not None:
                raise ValueError(f"round_operands={round_operands!r}")
            x = F.conv2d(x, w, stride=layer["stride"],
                         padding=layer["size"] // 2) + b[None, :, None, None]
            if layer["act"] == "leaky":
                x = torch.where(x >= 0, x, alpha * x)
        elif kind == "maxpool":
            x = _maxpool(x, layer["size"], layer["stride"])
        elif kind == "reorg":
            x = _reorg(x, layer["stride"])
        elif kind == "route":
            x = torch.cat([outputs[r if r >= 0 else i + r]
                           for r in layer["layers"]], dim=1)
        else:
            raise ValueError(f"layer {i}: unknown type {kind!r}")
        outputs.append(x)
    n, _, h, w = x.shape
    a = len(config["anchors"])
    return x.permute(0, 2, 3, 1).reshape(n, h, w, a, -1)


@torch.no_grad()
def batch_statistics(config: dict, weights: Weights, images: torch.Tensor,
                     eps: float = 1e-5) -> Weights:
    """Each BN conv's output mean and biased variance over ``images``
    (N, H, W, 3), normalising with them as a train-mode forward does:
    ``conv_<i>.mean`` and ``conv_<i>.var``."""
    alpha = float(config.get("leaky_alpha", 0.1))
    x = images.float().permute(0, 3, 1, 2)
    outputs: List[torch.Tensor] = []
    stats: Weights = {}
    for i, layer in enumerate(config["layers"]):
        kind = layer["type"]
        if kind == "conv":
            x = F.conv2d(x, weights[f"conv_{i}.w"], stride=layer["stride"],
                         padding=layer["size"] // 2)
            if layer["bn"]:
                m = x.mean(dim=(0, 2, 3))
                v = torch.square(x - m[None, :, None, None]).mean(
                    dim=(0, 2, 3))
                stats[f"conv_{i}.mean"], stats[f"conv_{i}.var"] = m, v
                x = ((x - m[None, :, None, None])
                     * torch.rsqrt(v + eps)[None, :, None, None]
                     * weights[f"conv_{i}.scale"][None, :, None, None]
                     + weights[f"conv_{i}.bias"][None, :, None, None])
            else:
                x = x + weights[f"conv_{i}.b"][None, :, None, None]
            if layer["act"] == "leaky":
                x = torch.where(x >= 0, x, alpha * x)
        elif kind == "maxpool":
            x = _maxpool(x, layer["size"], layer["stride"])
        elif kind == "reorg":
            x = _reorg(x, layer["stride"])
        elif kind == "route":
            x = torch.cat([outputs[r if r >= 0 else i + r]
                           for r in layer["layers"]], dim=1)
        outputs.append(x)
    return stats


def forward_blocks(config: dict, folded: Weights, images: torch.Tensor, *,
                   block: int = 16, **kw) -> torch.Tensor:
    """:func:`forward` over row blocks of ``images``, so that large
    batches fit beside what the run still holds."""
    return torch.cat([forward(config, folded, images[s:s + block], **kw)
                      for s in range(0, images.shape[0], block)])
