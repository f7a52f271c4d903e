"""Model registry: config strings -> spec lists (port of
``yolojax/models/__init__.py``).

``get_model("yolo2", "darknet", num_classes=20)`` returns a :class:`Model`
bundling the spec list with init/apply and head metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

from yolojax_torch.models import yolo as _yolo
from yolojax_torch.models import yolo2 as _yolo2
from yolojax_torch.nn.layers import Network, init_network

_REGISTRY = {
    ("yolo", "yolo"): (_yolo.yolo, "v1", _yolo.DOWNSAMPLE),
    ("yolo", "tiny"): (_yolo.tiny, "v1", _yolo.DOWNSAMPLE),
    ("yolo2", "darknet"): (_yolo2.darknet, "v2", _yolo2.DOWNSAMPLE),
    ("yolo2", "tiny"): (_yolo2.tiny, "v2", _yolo2.DOWNSAMPLE),
}


@dataclasses.dataclass(frozen=True)
class Model:
    """A detection model: backbone spec list + head metadata.

    v2 heads reshape to (N, H, W, A, 5+C); v1 heads stay flat
    (N, S*S*(C+5B)) — split with :func:`yolojax_torch.ops.boxes.split_v1_head`.
    """

    name: str          # "yolo" | "yolo2"
    inference: str     # "darknet" | "tiny" | "yolo"
    kind: str          # "v1" | "v2"
    specs: Tuple[Any, ...]
    num_classes: int
    downsample: int
    anchors: Optional[Tuple[Tuple[float, float], ...]] = None  # v2
    boxes_per_cell: int = 2                                    # v1
    grid: int = 7                                              # v1 (S)

    @property
    def num_anchors(self) -> int:
        return len(self.anchors) if self.anchors else 0

    def init(self, generator: torch.Generator, input_dim: int) -> Network:
        """He-normal weights drawn from ``generator``, on the CPU; move
        the result with ``.to(device)``."""
        return init_network(generator, self.specs, 3, (input_dim, input_dim))

    def apply(self, net: Network, images: torch.Tensor, *,
              compute_dtype: torch.dtype = torch.bfloat16,
              train: bool = False,
              generator: Optional[torch.Generator] = None,
              mesh=None):
        """images: (N, H, W, 3) in [0, 1]. Returns the f32 head; in train
        mode ``(head, new_bn_state)`` (see :meth:`Network.forward`)."""
        out = net(images, compute_dtype=compute_dtype, train=train,
                  generator=generator, mesh=mesh)
        if train:
            out, new_state = out
        if self.kind == "v2":
            n, h, w, _ = out.shape
            out = out.reshape(n, h, w, self.num_anchors, 5 + self.num_classes)
        return (out, new_state) if train else out


def get_model(
    name: str,
    inference: str,
    num_classes: int,
    *,
    anchors: Optional[Sequence[Tuple[float, float]]] = None,
    boxes_per_cell: int = 2,
    grid: int = 7,
) -> Model:
    key = (name, inference.lower())
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown model {name}.{inference}; have "
            + ", ".join(".".join(k) for k in _REGISTRY)
        )
    builder, kind, downsample = _REGISTRY[key]
    if kind == "v2":
        if anchors is None:
            anchors = (
                _yolo2.TINY_VOC_ANCHORS if inference == "tiny" else _yolo2.VOC_ANCHORS
            )
        specs = builder(num_classes, len(anchors))
        return Model(
            name, inference, kind, tuple(specs), num_classes, downsample,
            anchors=tuple(tuple(a) for a in anchors),
        )
    specs = builder(num_classes, boxes_per_cell, grid)
    return Model(
        name, inference, kind, tuple(specs), num_classes, downsample,
        boxes_per_cell=boxes_per_cell, grid=grid,
    )
