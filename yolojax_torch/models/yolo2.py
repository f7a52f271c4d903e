"""YOLOv2 backbones: Darknet-19 and Tiny-YOLO (arXiv:1612.08242).

Copy of ``yolojax/models/yolo2.py``: the same spec lists and anchors.
Fully convolutional, stride 32: 416x416 input -> 13x13 grid.

Head layout per anchor cell: [tx, ty, tw, th, to, c_0..c_{C-1}] with decode
  bx = sigma(tx) + cx, by = sigma(ty) + cy,
  bw = pw * exp(tw),   bh = ph * exp(th),
  conf = sigma(to),    probs = softmax(tc)
(see yolojax_torch/ops/boxes.py).
"""

from __future__ import annotations

from typing import Tuple

from yolojax_torch.nn.layers import ConvSpec, MaxPoolSpec, ReorgSpec, RouteSpec

# Default VOC anchors (in grid-cell units), as shipped with yolo-voc.cfg.
VOC_ANCHORS: Tuple[Tuple[float, float], ...] = (
    (1.3221, 1.73145),
    (3.19275, 4.00944),
    (5.05587, 8.09892),
    (9.47112, 4.84053),
    (11.2364, 10.0071),
)
TINY_VOC_ANCHORS: Tuple[Tuple[float, float], ...] = (
    (1.08, 1.19),
    (3.42, 4.41),
    (6.63, 11.38),
    (9.42, 5.11),
    (16.62, 10.52),
)
COCO_ANCHORS: Tuple[Tuple[float, float], ...] = (
    (0.57273, 0.677385),
    (1.87446, 2.06253),
    (3.33843, 5.47434),
    (7.88282, 3.52778),
    (9.77052, 9.16828),
)


def darknet(num_classes: int, num_anchors: int = 5):
    """Full YOLOv2: Darknet-19 backbone + reorg passthrough + anchor head.

    Spec indices (for the route layers):
      0..22   Darknet-19 trunk (conv/pool), spec 16 = 26x26x512 passthrough
      23..26  13x13x1024 detection convs
      27..29  passthrough branch: route(16) -> 1x1 conv 64 -> reorg s2
      30      concat(reorg, detection) -> 31 conv3-1024 -> 32 head 1x1
    """
    a, c = num_anchors, num_classes
    return (
        # Darknet-19 trunk -------------------------------------------- idx
        ConvSpec(32, 3),                # 0   416x416x32
        MaxPoolSpec(),                  # 1   208
        ConvSpec(64, 3),                # 2
        MaxPoolSpec(),                  # 3   104
        ConvSpec(128, 3),               # 4
        ConvSpec(64, 1),                # 5
        ConvSpec(128, 3),               # 6
        MaxPoolSpec(),                  # 7   52
        ConvSpec(256, 3),               # 8
        ConvSpec(128, 1),               # 9
        ConvSpec(256, 3),               # 10
        MaxPoolSpec(),                  # 11  26
        ConvSpec(512, 3),               # 12
        ConvSpec(256, 1),               # 13
        ConvSpec(512, 3),               # 14
        ConvSpec(256, 1),               # 15
        ConvSpec(512, 3),               # 16  <- passthrough source 26x26x512
        MaxPoolSpec(),                  # 17  13
        ConvSpec(1024, 3),              # 18
        ConvSpec(512, 1),               # 19
        ConvSpec(1024, 3),              # 20
        ConvSpec(512, 1),               # 21
        ConvSpec(1024, 3),              # 22
        # Detection head ----------------------------------------------
        ConvSpec(1024, 3),              # 23
        ConvSpec(1024, 3),              # 24  13x13x1024
        RouteSpec((16,)),               # 25  26x26x512
        ConvSpec(64, 1),                # 26  26x26x64
        ReorgSpec(2),                   # 27  13x13x256
        RouteSpec((-1, 24)),            # 28  13x13x1280
        ConvSpec(1024, 3),              # 29
        ConvSpec(a * (5 + c), 1, bn=False, act="linear"),  # 30
    )


def tiny(num_classes: int, num_anchors: int = 5):
    """Tiny-YOLOv2 (tiny-yolo-voc): 9 convs, last pool is stride 1."""
    a, c = num_anchors, num_classes
    return (
        ConvSpec(16, 3),
        MaxPoolSpec(),
        ConvSpec(32, 3),
        MaxPoolSpec(),
        ConvSpec(64, 3),
        MaxPoolSpec(),
        ConvSpec(128, 3),
        MaxPoolSpec(),
        ConvSpec(256, 3),
        MaxPoolSpec(),
        ConvSpec(512, 3),
        MaxPoolSpec(2, 1),              # stride-1 pool: stays 13x13
        ConvSpec(1024, 3),
        ConvSpec(1024, 3),
        ConvSpec(a * (5 + c), 1, bn=False, act="linear"),
    )


DOWNSAMPLE = 32  # input dim -> grid dim divisor for both backbones
