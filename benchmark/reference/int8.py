"""Plain reference of post-training int8 quantization of a YOLOv2 conv
trunk: calibration, quantization and the int8 forward, from the same
BN-folded float32 weights and canvases the program is given.

Scheme (symmetric, the one the program's ``detect.use_int8`` states):
per-output-channel kernel scales amax / qmax; per-layer activation
scales max(|activation| over the calibration images) / qmax from a
float32 forward; codes round(v / scale) clamped to +-qmax; each conv's
integer sums (exact, in float64) dequantised by in_scale * w_scale, plus
the bias, leaky, requantised at the layer's scale; pools and reorg on the
codes; a route dequantises its parts, concatenates and requantises at its
own scale; the head (the last conv) in float32 from its dequantised
input.

Departures from the program, by design of the comparison: calibration
runs float32 convolutions (the program's runs bf16), and the head is
float32 (the program's is bf16).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference.network import _maxpool, _reorg, conv_layers


def _codes(v: torch.Tensor, scale: float, qmax: int) -> torch.Tensor:
    return torch.clamp(torch.round(v / scale), -qmax, qmax)


def calibrate(config: dict, folded: Dict[str, torch.Tensor],
              images: torch.Tensor, qmax: int) -> List[float]:
    """[input scale, then each layer's output scale] from a float32
    forward over ``images`` (N, H, W, 3)."""
    alpha = float(config.get("leaky_alpha", 0.1))
    x = images.float().permute(0, 3, 1, 2)
    ranges = [float(x.abs().max())]
    outputs: List[torch.Tensor] = []
    for i, layer in enumerate(config["layers"]):
        kind = layer["type"]
        if kind == "conv":
            x = F.conv2d(x, folded[f"conv_{i}.w"], stride=layer["stride"],
                         padding=layer["size"] // 2) + folded[
                             f"conv_{i}.b"][None, :, None, None]
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
        ranges.append(float(x.abs().max()))
    return [max(r / qmax, 1e-8) for r in ranges]


def quantize(config: dict, folded: Dict[str, torch.Tensor],
             calib: torch.Tensor, bits: int = 8) -> dict:
    """The quantized model: kernel codes and scales, activation scales."""
    qmax = 2 ** (bits - 1) - 1
    convs = conv_layers(config)
    head = convs[-1]
    q = {"qmax": qmax, "head": head,
         "scales": calibrate(config, folded, calib, qmax)}
    for i in convs:
        w = folded[f"conv_{i}.w"]
        if i == head:
            continue
        ws = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-8) / qmax
        q[f"conv_{i}.w_q"] = _codes(w, ws[:, None, None, None], qmax)
        q[f"conv_{i}.w_scale"] = ws
    return q


def forward(config: dict, folded: Dict[str, torch.Tensor], q: dict,
            images: torch.Tensor) -> torch.Tensor:
    """images (N, H, W, 3) in [0, 1] -> the raw head (N, h, w, A, 5 + C)."""
    alpha = float(config.get("leaky_alpha", 0.1))
    qmax, scales = q["qmax"], q["scales"]
    in_scale = scales[0]
    x = _codes(images.float().permute(0, 3, 1, 2), in_scale, qmax)
    outputs = []  # (codes, scale)
    for i, layer in enumerate(config["layers"]):
        kind = layer["type"]
        out_scale = scales[i + 1]
        if kind == "conv" and i == q["head"]:
            x = F.conv2d(x * in_scale, folded[f"conv_{i}.w"],
                         stride=layer["stride"], padding=layer["size"] // 2
                         ) + folded[f"conv_{i}.b"][None, :, None, None]
        elif kind == "conv":
            acc = F.conv2d(x.double(), q[f"conv_{i}.w_q"].double(),
                           stride=layer["stride"],
                           padding=layer["size"] // 2)
            y = (acc * (in_scale * q[f"conv_{i}.w_scale"].double()
                        )[None, :, None, None]
                 + folded[f"conv_{i}.b"].double()[None, :, None, None])
            if layer["act"] == "leaky":
                y = torch.where(y >= 0, y, alpha * y)
            x = _codes(y.float(), out_scale, qmax)
            in_scale = out_scale
        elif kind == "maxpool":
            x = _maxpool(x, layer["size"], layer["stride"])
        elif kind == "reorg":
            x = _reorg(x, layer["stride"])
        elif kind == "route":
            parts = [outputs[r if r >= 0 else i + r] for r in layer["layers"]]
            x = _codes(torch.cat([p * s for p, s in parts], dim=1),
                       out_scale, qmax)
            in_scale = out_scale
        outputs.append((x, in_scale))
    n, _, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h, w, len(config["anchors"]), -1)


def forward_blocks(config, folded, q, images, block: int = 16):
    return torch.cat([forward(config, folded, q, images[s:s + block])
                      for s in range(0, images.shape[0], block)])

