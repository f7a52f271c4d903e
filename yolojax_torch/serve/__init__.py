"""Serving artifacts: the serving program frozen into one file.

Port of ``yolojax/serve/__init__.py``. ``torch.export`` traces the exact
program that ``cli/detect.py::build_serving`` binds (forward or int8 trunk,
decode, top-K, greedy NMS) with its weights, for one fixed input shape, on
one device. The three hand kernels stay in the graph as the custom
operators of ``kernels/ops.py``, so an artifact exported on the card runs
the kernels there, and one exported on the CPU runs their plain versions.
A deployment host loads and runs the file without the model-building code:
no spec list, no weight file, no config ``[model]`` section.

File format (not yolojax's: a ``.yjsa`` does not load here): ``MAGIC`` +
u32-le metadata length + metadata JSON (class names, input dim, fixed
batch, detect thresholds, export platforms) + the ``torch.export.save``
payload. ``platforms`` is ``["cuda"]`` or ``["cpu"]``, the export's
device type, and is checked at load.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import warnings
from typing import Any, Callable, Dict

import torch
from torch import nn

MAGIC = b"YJTORCHSERVE1\n"
JAX_MAGIC = b"YJAXSERVE1\n"  # yolojax's artifacts, refused with the route


@dataclasses.dataclass(frozen=True)
class ServingArtifact:
    """A loaded artifact: ``meta`` + a callable running the baked graph.

    ``__call__`` takes a float32 canvas batch of exactly ``(meta['batch'],
    meta['dim'], meta['dim'], 3)`` on ``device`` and returns the serving
    dict ``{boxes, scores, classes, keep}`` there."""

    meta: Dict[str, Any]
    device: torch.device
    _call: Callable[[torch.Tensor], Dict[str, torch.Tensor]]

    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            return self._call(images)


class ServingModule(nn.Module):
    """One serving program as a module for ``torch.export``: ``forward(
    images)`` runs ``infer_fn.forward`` on the module's own weights. A bf16
    program holds its network as the submodule ``net``; an int8 program
    holds each tensor of its :class:`~yolojax_torch.quantize.ptq.
    QuantizedModel` (codes, scales, GEMM operands) as a buffer and rebinds
    the model to them on each call, so the weights are the module's and
    not constants captured from outside it."""

    def __init__(self, infer_fn, net: nn.Module):
        super().__init__()
        self._forward = infer_fn.forward
        self._qm = infer_fn.qm
        self.net = net if self._qm is None else None
        if self._qm is not None:
            for name, lp in self._qm.qparams.items():
                for key, t in lp.items():
                    self.register_buffer(f"q_{name}_{key}", t)
            for name, layer in self._qm.layers.items():
                for key in ("operand", "m", "b"):
                    self.register_buffer(f"l_{name}_{key}",
                                         getattr(layer, key))

    def _bound_qm(self):
        qm = dataclasses.replace(self._qm, qparams={
            name: {key: getattr(self, f"q_{name}_{key}") for key in lp}
            for name, lp in self._qm.qparams.items()})
        qm.__dict__["layers"] = {  # the cached property, on these buffers
            name: layer._replace(**{key: getattr(self, f"l_{name}_{key}")
                                    for key in ("operand", "m", "b")})
            for name, layer in self._qm.layers.items()}
        return qm

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        qm = None if self._qm is None else self._bound_qm()
        return self._forward(self.net, images, qm=qm)


def save_artifact(path: str, infer_fn, net: nn.Module, *, batch: int,
                  dim: int, meta: Dict[str, Any],
                  device: torch.device) -> Dict[str, Any]:
    """Export ``infer_fn(net, images)`` (a ``make_infer_fn`` program) with
    its weights, for a fixed ``(batch, dim, dim, 3)`` float32 input on
    ``device``, and write the artifact file. Returns the final metadata
    (with the payload size and the platform it runs on)."""
    import yolojax_torch.kernels.ops  # noqa: F401  (the kernels' operators)

    device = torch.device(device)
    example = torch.full((batch, dim, dim, 3), 0.5, device=device)
    with torch.no_grad():
        exported = torch.export.export(ServingModule(infer_fn, net),
                                       (example,))
    buf = io.BytesIO()
    with warnings.catch_warnings():
        # the archive writer warns for weights that are not contiguous (the
        # channels_last conv kernels); it stores their storage whole
        warnings.filterwarnings("ignore", message="No complete tensor found")
        torch.export.save(exported, buf)
    payload = buf.getvalue()
    meta = dict(meta, batch=int(batch), dim=int(dim),
                platforms=[device.type], payload_bytes=len(payload))
    blob = json.dumps(meta).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(len(blob).to_bytes(4, "little"))
        f.write(blob)
        f.write(payload)
    return meta


def load_artifact(path: str, device=None) -> ServingArtifact:
    """Load an artifact for ``device`` (default: the CUDA card).

    Raises ``ValueError`` on a directory (naming the SavedModel loader), a
    bad magic (with the route for a yolojax ``.yjsa`` and the TFLite loader
    for a ``.tflite`` file), corrupt metadata,
    and when ``device`` is not of the platform the artifact was exported
    on."""
    import yolojax_torch.kernels.ops  # noqa: F401  (the kernels' operators)
    from yolojax_torch.utils.device import resolve_device

    if os.path.isdir(path):
        raise ValueError(
            f"{path}: is a directory, not a serving artifact — a SavedModel "
            "export (--format savedmodel) serves under TF Serving "
            "(yolojax_torch.serve.savedmodel.load_savedmodel), not "
            "--artifact; export one file with python -m "
            "yolojax_torch.cli.export")
    with open(path, "rb") as f:
        head = f.read(len(MAGIC))
        if head != MAGIC:
            if head.startswith(JAX_MAGIC):
                hint = (" — it is a yolojax (jax.export) artifact; re-export "
                        "the weights with python -m yolojax_torch.cli.export")
            elif path.endswith(".tflite"):
                hint = (" — .tflite flatbuffers serve under the TFLite "
                        "interpreter (yolojax_torch.serve.tflite.load_tflite), "
                        "not --artifact")
            else:
                hint = ""
            raise ValueError(
                f"{path}: not a yolojax_torch serving artifact (bad magic)"
                f"{hint}")
        n = int.from_bytes(f.read(4), "little")
        try:
            meta = json.loads(f.read(n).decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: corrupt artifact metadata: {e}")
        payload = f.read()
    device = resolve_device(device)
    platforms = [p.lower() for p in meta.get("platforms", [])]
    if device.type not in platforms:
        raise ValueError(
            f"{path}: artifact was exported for {platforms}, but the current "
            f"device is {device.type!r}; re-export on this platform")
    program = torch.export.load(io.BytesIO(payload)).module()
    return ServingArtifact(meta=meta, device=device, _call=program)
