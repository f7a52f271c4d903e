"""Darknet ``.weights`` import and export (port of
``yolojax/convert/darknet.py``).

The file is a header of three int32 (major, minor, revision) and ``seen``
(an int64 once ``major * 10 + minor >= 2``, an int32 before), then raw
float32 parameters in network order. Per conv layer:

    biases[out]
    if BN: scales[out], rolling_mean[out], rolling_var[out]
    weights[out, in, kh, kw]

and per connected (dense) layer: biases[out], weights[out, in]. These are
the port's own layouts (OIHW convs, (out, in) dense kernels), so nothing is
transposed on the way in or out. A dense layer's input is the NCHW flatten,
as the port's ``FlattenSpec`` flattens. Shapes come from a walk over the
specs (``nn/layers.py::weight_shapes``); ``input_dim`` sizes a v1 model's
flatten.

:func:`load_darknet_weights` returns a :class:`Network`, which
``convert/store.py::save_network_npz`` writes as the ``.npz`` yolojax
writes from the same file (HWIO kernels).
"""

from __future__ import annotations

import logging
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from yolojax_torch.convert.interchange import network_from_state_dict
from yolojax_torch.nn.layers import ConvSpec, DenseSpec, Network, weight_shapes

log = logging.getLogger(__name__)


def _layers(model):
    """(name, spec) of every conv and dense layer, in network order."""
    for i, spec in enumerate(model.specs):
        if isinstance(spec, ConvSpec):
            yield f"conv_{i}", spec
        elif isinstance(spec, DenseSpec):
            yield f"dense_{i}", spec


def _default_dim(model, input_dim: Optional[int]) -> int:
    if input_dim is not None:
        return int(input_dim)
    return 448 if model.kind == "v1" else 416


def read_darknet_header(path: str) -> Tuple[int, int, int, int]:
    """(major, minor, revision, seen) of a ``.weights`` file."""
    with open(path, "rb") as f:
        return _read_header(f)


def _read_header(f) -> Tuple[int, int, int, int]:
    major, minor, revision = struct.unpack("<3i", f.read(12))
    fmt, size = ("<q", 8) if major * 10 + minor >= 2 else ("<i", 4)
    (seen,) = struct.unpack(fmt, f.read(size))
    return major, minor, revision, seen


def _read_arrays(model, path: str, input_dim: Optional[int]
                 ) -> Dict[str, np.ndarray]:
    """{``conv_<i>.w`` ...: float32 array} in the port's layouts, in the
    file's order."""
    dim = _default_dim(model, input_dim)
    shapes = weight_shapes(model.specs, 3, (dim, dim))
    with open(path, "rb") as f:
        major, minor, revision, seen = _read_header(f)
        log.info("darknet header: %d.%d.%d seen=%d", major, minor, revision,
                 seen)
        buf = np.fromfile(f, dtype=np.float32)

    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > buf.size:
            raise ValueError(
                f"weights file exhausted: need {n} floats at {pos}, "
                f"have {buf.size}")
        out = buf[pos: pos + n].copy()
        pos += n
        return out

    out: Dict[str, np.ndarray] = {}
    for name, spec in _layers(model):
        shape = shapes[name]
        cout = shape[0]
        if isinstance(spec, ConvSpec) and spec.bn:
            for key in ("bias", "scale", "mean", "var"):
                out[f"{name}.{key}"] = take(cout)
        else:
            out[f"{name}.b"] = take(cout)
        out[f"{name}.w"] = take(int(np.prod(shape))).reshape(shape)
    if pos != buf.size:
        log.warning("darknet file has %d unread floats (model mismatch?)",
                    buf.size - pos)
    return out


def load_darknet_weights(model, path: str, *,
                         input_dim: Optional[int] = None) -> Network:
    """Parse a Darknet ``.weights`` file into a CPU :class:`Network`."""
    arrays = _read_arrays(model, path, input_dim)
    return network_from_state_dict(
        model, {k: torch.from_numpy(v) for k, v in arrays.items()})


def save_darknet_weights(model, net: Network, path: str, *, seen: int = 0,
                         version: Tuple[int, int, int] = (0, 2, 0)) -> None:
    """Write ``net``'s weights and BN statistics as a Darknet ``.weights``
    file (the header's ``seen`` is an int64 from version 0.2 on)."""
    major, minor, revision = version
    chunks = [struct.pack("<3i", major, minor, revision),
              struct.pack("<q" if major * 10 + minor >= 2 else "<i", seen)]
    sd = net.state_dict()

    def f32(name):
        return sd[name].detach().cpu().float().contiguous().numpy().tobytes()

    for name, spec in _layers(model):
        if isinstance(spec, ConvSpec) and spec.bn:
            keys = ("bias", "scale", "mean", "var", "w")
        else:
            keys = ("b", "w")
        chunks += [f32(f"{name}.{key}") for key in keys]
    with open(path, "wb") as f:
        f.write(b"".join(chunks))
