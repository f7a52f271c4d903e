"""YOLOv1 backbones: full 24-conv net and Tiny/Fast variant (arXiv:1506.02640).

Copy of ``yolojax/models/yolo.py``. S=7 grid, B boxes per cell, C classes;
the FC head emits S*S*(C + B*5) values ordered
  [class probs (S*S*C), confidences (S*S*B), boxes (S*S*B*4)]
matching Darknet's detection-layer layout.

YOLOv1 has no batch norm (pre-BN era); dropout 0.5 after the first FC.
"""

from __future__ import annotations

from yolojax_torch.nn.layers import (
    ConvSpec,
    DenseSpec,
    DropoutSpec,
    FlattenSpec,
    MaxPoolSpec,
)


def yolo(num_classes: int, boxes_per_cell: int = 2, grid: int = 7):
    """Full YOLOv1: 24 convs + 2 FC (448x448 input -> 7x7 grid)."""
    s, b, c = grid, boxes_per_cell, num_classes
    body = [
        ConvSpec(64, 7, stride=2, bn=False),
        MaxPoolSpec(),
        ConvSpec(192, 3, bn=False),
        MaxPoolSpec(),
        ConvSpec(128, 1, bn=False),
        ConvSpec(256, 3, bn=False),
        ConvSpec(256, 1, bn=False),
        ConvSpec(512, 3, bn=False),
        MaxPoolSpec(),
    ]
    for _ in range(4):
        body += [ConvSpec(256, 1, bn=False), ConvSpec(512, 3, bn=False)]
    body += [
        ConvSpec(512, 1, bn=False),
        ConvSpec(1024, 3, bn=False),
        MaxPoolSpec(),
        ConvSpec(512, 1, bn=False),
        ConvSpec(1024, 3, bn=False),
        ConvSpec(512, 1, bn=False),
        ConvSpec(1024, 3, bn=False),
        ConvSpec(1024, 3, bn=False),
        ConvSpec(1024, 3, stride=2, bn=False),
        ConvSpec(1024, 3, bn=False),
        ConvSpec(1024, 3, bn=False),
        FlattenSpec(),
        DenseSpec(4096, act="leaky"),
        DropoutSpec(0.5),
        DenseSpec(s * s * (c + b * 5), act="linear"),
    ]
    return tuple(body)


def tiny(num_classes: int, boxes_per_cell: int = 2, grid: int = 7):
    """Tiny/Fast YOLOv1: 9 convs + FC head (448x448 input)."""
    s, b, c = grid, boxes_per_cell, num_classes
    return (
        ConvSpec(16, 3, bn=False),
        MaxPoolSpec(),
        ConvSpec(32, 3, bn=False),
        MaxPoolSpec(),
        ConvSpec(64, 3, bn=False),
        MaxPoolSpec(),
        ConvSpec(128, 3, bn=False),
        MaxPoolSpec(),
        ConvSpec(256, 3, bn=False),
        MaxPoolSpec(),
        ConvSpec(512, 3, bn=False),
        MaxPoolSpec(),
        ConvSpec(1024, 3, bn=False),
        ConvSpec(1024, 3, bn=False),
        ConvSpec(1024, 3, bn=False),
        FlattenSpec(),
        DenseSpec(256, act="linear"),
        DenseSpec(4096, act="leaky"),
        DropoutSpec(0.5),
        DenseSpec(s * s * (c + b * 5), act="linear"),
    )


DOWNSAMPLE = 64  # 448 -> 7
