"""Weights interchange with yolojax's parameter pytrees.

yolojax keeps trainables and BN running statistics as two nested dicts of
arrays, ``params = {"conv_<i>": {"w" (HWIO), "b" | "scale", "bias"},
"dense_<i>": {"w" (in, out), "b"}}`` and ``state = {"conv_<i>": {"mean",
"var"}}``; the ``.npz`` store (``convert/store.py``) is that layout
flattened. The port holds the same numbers in a :class:`Network`, with conv
kernels OIHW and dense kernels (out, in). These two functions convert
exactly (transposes only) in both directions. A model with a fused stem
(``nn/stem.py``) carries ``conv_0 = {"wp" (3, 3, 12, 4*Co) packed HWIO,
"b"}`` in both layouts, and its ``NoOpSpec`` slot carries nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from yolojax_torch.nn.layers import (
    ConvLayer,
    ConvSpec,
    DenseLayer,
    DenseSpec,
    Network,
    StemLayer,
)
from yolojax_torch.nn.stem import StemSpec


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def params_from_jax(model, params: Dict[str, Any],
                    state: Dict[str, Any]) -> Network:
    """yolojax (params, state) pytrees of arrays -> a CPU :class:`Network`."""
    layers = {}
    for i, spec in enumerate(model.specs):
        if isinstance(spec, StemSpec):
            p = params[f"conv_{i}"]
            layers[f"conv_{i}"] = StemLayer(_tensor(p["wp"]), _tensor(p["b"]))
        elif isinstance(spec, ConvSpec):
            name = f"conv_{i}"
            p = params[name]
            w = _tensor(p["w"]).permute(3, 2, 0, 1).contiguous()  # HWIO->OIHW
            if spec.bn:
                st = state[name]
                layers[name] = ConvLayer(
                    w, scale=_tensor(p["scale"]), bias=_tensor(p["bias"]),
                    mean=_tensor(st["mean"]), var=_tensor(st["var"]))
            else:
                layers[name] = ConvLayer(w, b=_tensor(p["b"]))
        elif isinstance(spec, DenseSpec):
            name = f"dense_{i}"
            p = params[name]
            layers[name] = DenseLayer(_tensor(p["w"]).T.contiguous(),
                                      _tensor(p["b"]))
    return Network(model.specs, layers)


def params_to_jax(model, net: Network
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of :func:`params_from_jax`: numpy (params, state)."""

    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().contiguous().numpy()

    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    for i, spec in enumerate(model.specs):
        if isinstance(spec, StemSpec):
            layer = getattr(net, f"conv_{i}")
            params[f"conv_{i}"] = {"wp": arr(layer.wp), "b": arr(layer.b)}
        elif isinstance(spec, ConvSpec):
            name = f"conv_{i}"
            layer = getattr(net, name)
            p = {"w": arr(layer.w.permute(2, 3, 1, 0))}  # OIHW -> HWIO
            if spec.bn:
                p["scale"] = arr(layer.scale)
                p["bias"] = arr(layer.bias)
                state[name] = {"mean": arr(layer.mean), "var": arr(layer.var)}
            else:
                p["b"] = arr(layer.b)
            params[name] = p
        elif isinstance(spec, DenseSpec):
            name = f"dense_{i}"
            layer = getattr(net, name)
            params[name] = {"w": arr(layer.w.T), "b": arr(layer.b)}
    return params, state
