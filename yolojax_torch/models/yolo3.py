"""YOLOv3: Darknet-53 and three detection scales (arXiv:1804.02767).

The 107 layers of Darknet's ``cfg/yolov3.cfg``, one spec each, so that a
spec's index is the cfg's layer index: the Darknet-53 trunk (52 convs,
strided 3x3/2 convs in place of pools, 23 residual ``[shortcut]
from=-3``), then three heads. The 19x19 head (layers 75-82) reads the
trunk's end; the 38x38 head (84-94) routes back to conv 79, a 1x1 conv
halves its channels, ``[upsample] stride=2`` doubles its grid and
``[route] -1, 61`` joins the trunk's 38x38 output; the 76x76 head
(96-106) does the same from conv 91 with layer 36.

Head layout per anchor cell: [tx, ty, tw, th, to, c_0..c_{C-1}] with
decode (``yolojax_torch/ops/boxes.py::decode_v3``)
  bx = (sigma(tx) + cx) / W,   by = (sigma(ty) + cy) / H
  bw = pw * exp(tw) / dim,     bh = ph * exp(th) / dim  (anchors in pixels)
  conf = sigma(to),            probs = sigma(tc) (independent logistics)
"""

from __future__ import annotations

from typing import Tuple

from yolojax_torch.nn.layers import (
    ConvSpec,
    RouteSpec,
    ShortcutSpec,
    UpsampleSpec,
    YoloSpec,
)

# yolov3.cfg's anchors, in input pixels, and each [yolo] layer's mask
COCO_ANCHORS: Tuple[Tuple[float, float], ...] = (
    (10, 13), (16, 30), (33, 23), (30, 61), (62, 45), (59, 119),
    (116, 90), (156, 198), (373, 326),
)
MASKS: Tuple[Tuple[int, ...], ...] = ((6, 7, 8), (3, 4, 5), (0, 1, 2))


def _blocks(n: int, width: int):
    """n residual blocks: 1x1 conv to width/2, 3x3 conv to width, add."""
    for _ in range(n):
        yield ConvSpec(width // 2, 1)
        yield ConvSpec(width, 3)
        yield ShortcutSpec(-3)


def _head(width: int, out: int):
    """Five alternating 1x1/3x3 convs, the 3x3 of the prediction, the
    linear 1x1 prediction and its [yolo] layer."""
    for _ in range(3):
        yield ConvSpec(width, 1)
        yield ConvSpec(2 * width, 3)
    yield ConvSpec(out, 1, bn=False, act="linear")
    yield YoloSpec()


def darknet(num_classes: int, num_anchors: int = 3):
    """Full YOLOv3 (yolov3.cfg): ``num_anchors`` anchors a scale."""
    out = num_anchors * (5 + num_classes)
    specs = [ConvSpec(32, 3)]                                   # 0
    for width, n in ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)):
        specs.append(ConvSpec(width, 3, stride=2))
        specs.extend(_blocks(n, width))                         # ..74
    specs.extend(_head(512, out))                               # 75..82
    specs += [RouteSpec((79,)), ConvSpec(256, 1), UpsampleSpec(2),
              RouteSpec((85, 61))]                              # 83..86
    specs.extend(_head(256, out))                               # 87..94
    specs += [RouteSpec((91,)), ConvSpec(128, 1), UpsampleSpec(2),
              RouteSpec((97, 36))]                              # 95..98
    specs.extend(_head(128, out))                               # 99..106
    return tuple(specs)


DOWNSAMPLE = 32  # input dim -> the coarsest grid
