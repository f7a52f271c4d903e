"""Plain float32 reference of YOLOv3 (arXiv:1804.02767), built from a
configuration file's layer list (``benchmark/configs/yolo3-coco-608.json``,
a transcription of Darknet's ``cfg/yolov3.cfg``): the seeded weights and
their BN statistics, the forward, the three heads and their decode.

Plain PyTorch: NCHW, ``F.conv2d`` in float32 with TF32 off (the caller
sets the backend flags: :func:`network.float32_exact`), nothing of the
program. The letterbox, top-K and greedy NMS are ``reference/detect.py``'s,
which do not depend on the YOLO version; the BN fold and the float8
operand rounding of the control are ``reference/network.py``'s. Departures
from Darknet:

* BN is folded into the convolution at eps 1e-5 (Darknet normalises with
  1e-6);
* after the decode, the K best (box, class) scores of all three heads go
  through one greedy NMS over all classes, each box shifted by class *
  4.0 (``detect.greedy_nms``), where Darknet's ``do_nms_sort`` sorts and
  suppresses each class apart;
* no objectness pre-threshold: Darknet drops a box whose objectness is
  under the threshold before it scores classes. Every score of such a box
  is under the threshold too (a score is objectness x a class logistic),
  so the kept set above the threshold is the same.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import detect, network

Weights = Dict[str, torch.Tensor]


def make_weights(config: dict, seed: int, device) -> Weights:
    """The weight law of ``inputs.make_weights``, for YOLOv3's layers:
    He-normal kernels (leaky gain), BN scale U(0.5, 1.5) and bias N(1,
    0.2), a zero bias on the three linear head convs; the BN running
    statistics are the batch statistics of eight seeded images through the
    network (:func:`batch_statistics`). ``conv_<i>`` keys, ``<i>`` the
    layer's index in the configuration."""
    from benchmark.inputs import conv_shapes, make_images

    gen = torch.Generator(device).manual_seed(int(seed))
    shapes = conv_shapes(config)
    sizes = [math.prod(s) for s in shapes.values()]
    kernels = torch.randn(sum(sizes), generator=gen, device=device)
    bn = [i for i in shapes if config["layers"][i]["bn"]]
    width = sum(shapes[i][0] for i in bn)
    normal = torch.randn((width,), generator=gen, device=device) * 0.2 + 1
    uniform = torch.rand((width,), generator=gen, device=device) + 0.5
    out: Weights = {}
    at = col = 0
    for (i, shape), size in zip(shapes.items(), sizes):
        o, cin, k, _ = shape
        out[f"conv_{i}.w"] = (kernels[at:at + size].reshape(shape)
                              * math.sqrt(2.0 / (k * k * cin)))
        at += size
        if i in bn:
            part = slice(col, col + o)
            out[f"conv_{i}.scale"] = uniform[part]
            out[f"conv_{i}.bias"] = normal[part]
            col += o
        else:
            out[f"conv_{i}.b"] = torch.zeros(o, device=device)
    images = make_images([(500, 375), (375, 500), (640, 480), (500, 500)] * 2,
                         seed + 7, device)
    canvases = torch.stack([detect.letterbox(im, config["input"])
                            for im in images])
    with network.float32_exact():
        out.update(batch_statistics(config, out, canvases))
    return out


def _upsample(x: torch.Tensor, s: int) -> torch.Tensor:
    """Nearest neighbour: each value over an s x s block (NCHW)."""
    return x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)


def _run(config: dict, images: torch.Tensor, conv) -> List[torch.Tensor]:
    """The layer list over images (N, H, W, 3) float32 in [0, 1], with
    ``conv(i, layer, x)`` computing conv ``i`` and its epilogue; returns
    the [yolo] layers' inputs (NCHW), in layer order."""
    x = images.float().permute(0, 3, 1, 2)
    outputs: List[torch.Tensor] = []
    heads: List[torch.Tensor] = []
    for i, layer in enumerate(config["layers"]):
        kind = layer["type"]
        if kind == "conv":
            x = conv(i, layer, x)
        elif kind == "shortcut":
            x = x + outputs[i + layer["from"]]
        elif kind == "upsample":
            x = _upsample(x, layer["stride"])
        elif kind == "route":
            x = torch.cat([outputs[r if r >= 0 else i + r]
                           for r in layer["layers"]], dim=1)
        elif kind == "yolo":
            heads.append(x)
        else:
            raise ValueError(f"layer {i}: unknown type {kind!r}")
        outputs.append(x)
    return heads


def _leaky(x: torch.Tensor, layer: dict, alpha: float) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x) if layer["act"] == "leaky" else x


def forward(config: dict, folded: Weights, images: torch.Tensor, *,
            round_operands: Optional[str] = None
            ) -> Tuple[torch.Tensor, ...]:
    """images (N, H, W, 3) -> the three raw heads, each (N, h, w, A, 5 +
    C) float32, A the anchors of its mask. ``round_operands="fp8"``: every
    convolution's input and kernel rounded to float8 e4m3 (the control)."""
    alpha = float(config.get("leaky_alpha", 0.1))

    def conv(i, layer, x):
        w, b = folded[f"conv_{i}.w"], folded[f"conv_{i}.b"]
        if round_operands == "fp8":
            x, w = network.fp8_round(x), network.fp8_round(w)
        elif round_operands is not None:
            raise ValueError(f"round_operands={round_operands!r}")
        x = F.conv2d(x, w, stride=layer["stride"],
                     padding=layer["size"] // 2) + b[None, :, None, None]
        return _leaky(x, layer, alpha)

    heads = _run(config, images, conv)
    out = []
    for h, mask in zip(heads, config["masks"]):
        n, _, gh, gw = h.shape
        out.append(h.permute(0, 2, 3, 1).reshape(n, gh, gw, len(mask), -1))
    return tuple(out)


@torch.no_grad()
def batch_statistics(config: dict, weights: Weights, images: torch.Tensor,
                     eps: float = 1e-5) -> Weights:
    """Each BN conv's output mean and biased variance over ``images``,
    normalising with them as a train-mode forward does:
    ``conv_<i>.mean`` and ``conv_<i>.var``."""
    alpha = float(config.get("leaky_alpha", 0.1))
    stats: Weights = {}

    def conv(i, layer, x):
        x = F.conv2d(x, weights[f"conv_{i}.w"], stride=layer["stride"],
                     padding=layer["size"] // 2)
        if layer["bn"]:
            m = x.mean(dim=(0, 2, 3))
            v = torch.square(x - m[None, :, None, None]).mean(dim=(0, 2, 3))
            stats[f"conv_{i}.mean"], stats[f"conv_{i}.var"] = m, v
            x = ((x - m[None, :, None, None])
                 * torch.rsqrt(v + eps)[None, :, None, None]
                 * weights[f"conv_{i}.scale"][None, :, None, None]
                 + weights[f"conv_{i}.bias"][None, :, None, None])
        else:
            x = x + weights[f"conv_{i}.b"][None, :, None, None]
        return _leaky(x, layer, alpha)

    _run(config, images, conv)
    return stats


def forward_blocks(config: dict, folded: Weights, images: torch.Tensor, *,
                   block: int = 16, **kw) -> Tuple[torch.Tensor, ...]:
    """:func:`forward` over row blocks of ``images``, so that large
    batches fit beside what the run still holds."""
    parts = [forward(config, folded, images[s:s + block], **kw)
             for s in range(0, images.shape[0], block)]
    return tuple(torch.cat(p) for p in zip(*parts))


def decode(heads: Sequence[torch.Tensor], anchors: Sequence[Sequence[float]],
           masks: Sequence[Sequence[int]], dim: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The heads -> corners (N, M, 4) (ymin, xmin, ymax, xmax) normalised
    and scores (N, M, C) = sigmoid(to) * sigmoid(tc), M the heads' cells x
    anchors in head order, each head's in (h, w, a) order. Anchors are in
    input pixels: bw = pw * exp(tw) / dim."""
    corners, scores = [], []
    for head, mask in zip(heads, masks):
        n, h, w, a, _ = head.shape
        dev = head.device
        anc = torch.tensor([anchors[k] for k in mask], dtype=torch.float32,
                           device=dev)
        cy, cx = torch.meshgrid(
            torch.arange(h, device=dev, dtype=torch.float32),
            torch.arange(w, device=dev, dtype=torch.float32), indexing="ij")
        bx = (torch.sigmoid(head[..., 0]) + cx[:, :, None]) / w
        by = (torch.sigmoid(head[..., 1]) + cy[:, :, None]) / h
        bw = anc[:, 0] * torch.exp(head[..., 2]) / dim
        bh = anc[:, 1] * torch.exp(head[..., 3]) / dim
        corners.append(torch.stack([by - bh / 2, bx - bw / 2, by + bh / 2,
                                    bx + bw / 2], dim=-1).reshape(n, -1, 4))
        s = torch.sigmoid(head[..., 4])[..., None] * torch.sigmoid(
            head[..., 5:])
        scores.append(s.reshape(n, h * w * a, -1))
    return torch.cat(corners, 1), torch.cat(scores, 1)
