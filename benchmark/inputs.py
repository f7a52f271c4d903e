"""Everything a run feeds the program, made from ``--seed``: the weights
of a configuration and the images of a mix.

Weights are made on the device in a few large draws, in float32, keyed by
the names the port's ``Network.state_dict()`` uses (``conv_<i>.w`` OIHW,
``.scale``/``.bias``/``.mean``/``.var`` for a BN conv, ``.b`` otherwise),
where ``<i>`` is the layer's index in the configuration's layer list.
The reference reads these tensors; the program gets them through a file.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def conv_shapes(config: dict) -> Dict[int, Tuple[int, int, int, int]]:
    """OIHW kernel shape of each conv layer, by layer index."""
    chans: List[int] = []
    c = 3
    shapes = {}
    for i, layer in enumerate(config["layers"]):
        kind = layer["type"]
        if kind == "conv":
            shapes[i] = (layer["filters"], c, layer["size"], layer["size"])
            c = layer["filters"]
        elif kind == "reorg":
            c = c * layer["stride"] ** 2
        elif kind == "route":
            c = sum(chans[r if r >= 0 else i + r] for r in layer["layers"])
        chans.append(c)
    return shapes


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """He-normal kernels (leaky gain); BN scale U(0.5, 1.5) and bias N(1,
    0.2); a zero bias on layers without BN, but for the head's objectness
    where the configuration holds ``head_objectness``
    (:func:`objectness_bias`). The BN running statistics are
    those a trained network holds, its data's: the batch statistics of
    eight seeded images (:func:`make_images`, letterboxed) through the
    network, by the float32 reference.

    Both choices keep the random network as tame as a trained one.
    Random running statistics leave the activations unnormalised, their
    scale drifting layer by layer until softmax and sigmoid saturate. A
    BN bias around 0 makes the normalised network chaotic: a rounding's
    relative effect grows about 15% a layer, 26% at Darknet-19's head in
    bf16, where a trained detector's bf16 and float32 detections agree;
    with most units active (bias around 1) it is 4.6%."""
    gen = torch.Generator(device).manual_seed(int(seed))
    shapes = conv_shapes(config)
    sizes = [math.prod(s) for s in shapes.values()]
    kernels = torch.randn(sum(sizes), generator=gen, device=device)
    bn = [i for i in shapes if config["layers"][i]["bn"]]
    width = sum(shapes[i][0] for i in bn)
    normal = torch.randn((width,), generator=gen, device=device) * 0.2 + 1
    uniform = torch.rand((width,), generator=gen, device=device) + 0.5
    out: Dict[str, torch.Tensor] = {}
    at = col = 0
    for (i, shape), size in zip(shapes.items(), sizes):
        o, cin, k, _ = shape
        out[f"conv_{i}.w"] = (kernels[at:at + size].reshape(shape)
                              * math.sqrt(2.0 / (k * k * cin)))
        at += size
        if i in bn:
            part = slice(col, col + o)
            out[f"conv_{i}.scale"] = uniform[part]
            out[f"conv_{i}.bias"] = normal[part]
            col += o
        else:
            out[f"conv_{i}.b"] = torch.zeros(o, device=device)
    from benchmark.reference import detect, network

    images = make_images([(500, 375), (375, 500), (640, 480), (500, 500)] * 2,
                         seed + 7, device)
    canvases = torch.stack([detect.letterbox(im, config["input"])
                            for im in images])
    with network.float32_exact():
        out.update(network.batch_statistics(config, out, canvases))
        if "head_objectness" in config:
            head = max(shapes)
            out[f"conv_{head}.b"] = objectness_bias(
                config, out, canvases, config["head_objectness"])
    return out


def objectness_bias(config: dict, weights: Dict[str, torch.Tensor],
                    canvases: torch.Tensor, spec: dict) -> torch.Tensor:
    """The head's bias: zero but on each anchor's objectness logit,
    where it is the largest value (to 1/2**20) at which the calibration
    canvases give at most ``spec["detections_per_image"]`` kept
    detections an image, by the reference's decode, top-K and NMS at the
    spec's threshold. A trained detector returns a handful of detections
    on a VOC image; random weights with a zero bias return a hundred or
    more, and so would set a served reply's work."""
    from benchmark.reference import detect, network

    head = network.forward(config, network.fold(config, weights), canvases)
    target = spec["detections_per_image"] * canvases.shape[0]

    def kept(b: float) -> int:
        h = head.clone()
        h[..., 4] += b
        corners, scores = detect.decode(h, config["anchors"])
        return int(detect.detections(
            corners, scores, top_k=spec["top_k"],
            score_thresh=spec["score_thresh"],
            iou_thresh=spec["iou_thresh"])["keep"].sum())

    lo, hi = -32.0, 8.0
    while hi - lo > 2.0 ** -20:
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if kept(mid) <= target else (lo, mid)
    per_anchor = head.shape[-1]
    bias = torch.zeros(len(config["anchors"]) * per_anchor,
                       device=canvases.device)
    bias[4::per_anchor] = lo
    return bias


def seeded_order(seed: int, n: int) -> np.ndarray:
    """A permutation of range(n) drawn from the seed."""
    return np.random.default_rng(int(seed)).permutation(n)


def size_list(spec: Sequence[Sequence[int]], n: int, seed: int
              ) -> List[Tuple[int, int]]:
    """n (width, height) pairs: the mix's sizes in equal shares (the same
    multiset for every seed), in an order drawn from the seed."""
    sizes = [tuple(spec[k % len(spec)]) for k in range(n)]
    return [sizes[k] for k in seeded_order(seed + 1, n)]


def make_images(sizes: Sequence[Tuple[int, int]], seed: int, device
                ) -> List[torch.Tensor]:
    """uint8 RGB (h, w, 3) images on ``device``: a smooth random colour
    field (a 12x16 grid of uniform values, scaled up bilinearly) plus
    N(0, 12) noise, so that resizing them does real work."""
    gen = torch.Generator(device).manual_seed(int(seed) + 2)
    n = len(sizes)
    grids = torch.rand((n, 3, 12, 16), generator=gen, device=device) * 255
    total = sum(w * h * 3 for w, h in sizes)
    noise = torch.randn(total, generator=gen, device=device) * 12
    images, at = [], 0
    for k, (w, h) in enumerate(sizes):
        field = F.interpolate(grids[k:k + 1], size=(h, w), mode="bilinear",
                              align_corners=False)[0].permute(1, 2, 0)
        px = field + noise[at:at + w * h * 3].reshape(h, w, 3)
        at += w * h * 3
        images.append(px.clamp_(0, 255).round_().to(torch.uint8))
    return images
