"""TF1 checkpoint -> port :class:`Network` (port of
``yolojax/convert/tf1.py``).

The reader is generic: it lists the checkpoint's variables with
``tf.train.load_checkpoint``, groups them into conv / dense layers by the
slim-era names (``.../weights``, ``.../biases``,
``.../BatchNorm/{gamma,beta,moving_mean,moving_variance}``), orders the
groups by the numbers in their names (``Conv`` before ``Conv_1``), skips
optimizer slots, and maps them onto the model's conv and dense layers in
order. An explicit ``name_map`` (one variable scope per layer) overrides
the grouping when a real checkpoint disagrees.

TF1 conv kernels are HWIO and are permuted to the port's OIHW. TF1 dense
kernels are (in, out) over an NHWC flatten; the port flattens NCHW, so the
first dense layer after a flatten is permuted to NCHW flatten order (with
yolojax's own spatial arithmetic, :func:`_pre_flatten_hwc`), and every
dense kernel is transposed to (out, in). ``tensorflow`` is imported only
when a checkpoint is read.
"""

from __future__ import annotations

import logging
import math
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from yolojax_torch.convert.interchange import network_from_state_dict
from yolojax_torch.nn.layers import (
    ConvSpec,
    DenseSpec,
    FlattenSpec,
    MaxPoolSpec,
    Network,
    weight_shapes,
)

log = logging.getLogger(__name__)

_BN_SUFFIX = {
    "gamma": "scale",
    "beta": "bias",
    "moving_mean": "mean",
    "moving_variance": "var",
}
_SKIPPED = ("Momentum", "Adam", "RMSProp", "global_step",
            "ExponentialMovingAverage", "beta1_power", "beta2_power")


def _group_tf1_variables(reader) -> List[Dict[str, np.ndarray]]:
    """Group checkpoint variables into per-layer dicts, ordered by the
    numeric components of their names (slim layers are Conv, Conv_1, ...)."""
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for name in reader.get_variable_to_shape_map():
        if any(s in name for s in _SKIPPED):
            continue
        base = name
        kind = None
        for suf, std in _BN_SUFFIX.items():
            if name.endswith("BatchNorm/" + suf):
                base = name[: -len("/BatchNorm/" + suf)]
                kind = std
        if kind is None:
            if name.endswith("/weights") or name.endswith("/kernel"):
                base, kind = name.rsplit("/", 1)[0], "w"
            elif name.endswith("/biases") or name.endswith("/bias"):
                base, kind = name.rsplit("/", 1)[0], "b"
            else:
                log.debug("skipping unrecognized variable %s", name)
                continue
        groups.setdefault(base, {})[kind] = reader.get_tensor(name)

    def order_key(base: str):
        return ([int(x) for x in re.findall(r"\d+", base)], base)

    return [groups[b] for b in sorted(groups, key=order_key)]


def _named_groups(reader, name_map: List[str]
                  ) -> List[Dict[str, np.ndarray]]:
    """One group per scope in ``name_map``, in that order."""
    shape_map = reader.get_variable_to_shape_map()
    groups = []
    for base in name_map:
        g = {}
        for name in shape_map:
            if not name.startswith(base + "/"):
                continue
            suffix = name[len(base) + 1:]
            for suf, std in _BN_SUFFIX.items():
                if suffix == "BatchNorm/" + suf:
                    g[std] = reader.get_tensor(name)
            if suffix in ("weights", "kernel"):
                g["w"] = reader.get_tensor(name)
            if suffix in ("biases", "bias"):
                g["b"] = reader.get_tensor(name)
        groups.append(g)
    return groups


def load_tf1_checkpoint(model, ckpt_path: str, *,
                        input_dim: Optional[int] = None,
                        name_map: Optional[List[str]] = None) -> Network:
    """Read a TF1 checkpoint into a CPU :class:`Network` for ``model``."""
    import tensorflow as tf

    if input_dim is None:
        input_dim = 448 if model.kind == "v1" else 416
    reader = tf.train.load_checkpoint(ckpt_path)
    groups = (_group_tf1_variables(reader) if name_map is None
              else _named_groups(reader, name_map))

    layer_specs = [(i, s) for i, s in enumerate(model.specs)
                   if isinstance(s, (ConvSpec, DenseSpec))]
    if len(groups) != len(layer_specs):
        raise ValueError(
            f"checkpoint has {len(groups)} parameterized layers, model "
            f"expects {len(layer_specs)}; pass name_map to disambiguate")
    shapes = weight_shapes(model.specs, 3, (input_dim, input_dim))

    def f32(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    sd: Dict[str, torch.Tensor] = {}
    for (i, spec), g in zip(layer_specs, groups):
        w = np.asarray(g["w"], np.float32)
        if isinstance(spec, ConvSpec):
            name = f"conv_{i}"
            o, c, kh, kw = shapes[name]
            want = (kh, kw, c, o)  # HWIO, as the checkpoint holds it
            if tuple(w.shape) != want:
                raise ValueError(f"{name}: ckpt {w.shape} != model {want}")
            sd[f"{name}.w"] = f32(w.transpose(3, 2, 0, 1))
            keys = ("scale", "bias", "mean", "var") if spec.bn else ("b",)
        else:
            name = f"dense_{i}"
            want = shapes[name][::-1]  # (in, out), over an NHWC flatten
            if tuple(w.shape) != want:
                raise ValueError(f"{name}: ckpt {w.shape} != model {want}")
            if isinstance(model.specs[i - 1], FlattenSpec):
                h, w_sp, c = _pre_flatten_hwc(model, i, input_dim)
                w = (w.reshape(h, w_sp, c, -1).transpose(2, 0, 1, 3)
                     .reshape(h * w_sp * c, -1))
            sd[f"{name}.w"] = f32(w.T)
            keys = ("b",)
        for key in keys:
            sd[f"{name}.{key}"] = f32(g[key])
    return network_from_state_dict(model, sd)


def _pre_flatten_hwc(model, dense_idx: int, input_dim: int):
    """Spatial dims (h, w, c) feeding the FlattenSpec before ``dense_idx``
    (yolojax's arithmetic: Darknet convs, ceil pools)."""
    h = w = input_dim
    c = 3
    for spec in model.specs[: dense_idx - 1]:
        if isinstance(spec, ConvSpec):
            h = (h + 2 * (spec.ksize // 2) - spec.ksize) // spec.stride + 1
            w = (w + 2 * (spec.ksize // 2) - spec.ksize) // spec.stride + 1
            c = spec.out
        elif isinstance(spec, MaxPoolSpec):
            h = math.ceil(h / spec.stride)
            w = math.ceil(w / spec.stride)
    return h, w, c
