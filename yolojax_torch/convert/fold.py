"""Inference-time BN folding: conv+BN -> conv+bias.

Port of ``yolojax/convert/fold.py``: w' = w * (scale / sqrt(var + eps))
per output channel, b' = bias - mean * scale / sqrt(var + eps), computed in
float64 in yolojax's operation order and rounded once to float32, so the
folded weights are bit-identical to yolojax's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from yolojax_torch.nn.layers import ConvLayer, ConvSpec, Network


def fold_bn(model, net: Network, *, eps: float = 1e-5) -> Tuple[object, Network]:
    """Return (model', net') with every BN-conv folded to a bias-conv.
    Layers without BN are shared with ``net``, not copied.

    ``eps`` must match the forward's ``bn_eps``.
    """
    new_specs = []
    layers = {}
    for i, spec in enumerate(model.specs):
        name = f"conv_{i}"
        if isinstance(spec, ConvSpec) and spec.bn:
            layer = getattr(net, name)
            scale = layer.scale.detach().double()
            bias = layer.bias.detach().double()
            mean = layer.mean.double()
            var = layer.var.double()
            inv = scale / torch.sqrt(var + eps)
            w = layer.w.detach().double() * inv[:, None, None, None]  # OIHW
            b = bias - mean * inv
            new_specs.append(dataclasses.replace(spec, bn=False))
            layers[name] = ConvLayer(w.float(), b=b.float())
        else:
            new_specs.append(spec)
            for lname in (name, f"dense_{i}"):
                if hasattr(net, lname):
                    layers[lname] = getattr(net, lname)
    new_model = dataclasses.replace(model, specs=tuple(new_specs))
    return new_model, Network(new_model.specs, layers)
