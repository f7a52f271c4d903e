"""Plain float32 reference of a YOLOv2 training step: the augmentation,
the train-mode forward (BN on the batch's statistics), the region loss,
its gradients by autograd and the momentum update with weight decay.

Published description: Darknet's region layer (arXiv:1612.08242; the
``[region]`` section of the cfg) and its jitter / HSV augmentation.
Departures, all shared with the program under test:

* augmentation: each image is zoomed by z in [1 - jitter, 1 + jitter]
  per axis, shifted by o (left/up when zooming in, padding when zooming
  out), resampled with the linear kernel of ``jax.image.scale_and_
  translate`` (antialiased), flipped with probability 1/2, then jittered
  in HSV; boxes follow, are clipped to the frame and dropped below
  ``min_box``. The draws come from a ``torch.Generator`` on the device,
  seeded per step, in a fixed order (a frozen copy of the program's draw
  sequence: the random numbers are part of the step's input);
* the loss sums over each image and averages over the batch; a GT is
  assigned to its cell and the anchor of best shape IoU, the last GT
  wins a shared slot; the coord term weights (2 - w*h) and targets
  (sigmoid offsets, log size ratios); the objectness target is the
  predicted box's IoU with its GT (detached); anchors whose best IoU with
  any GT is at most ``thresh`` and that hold no GT pay the no-object
  term; the class term is the squared error of the softmax;
* weight decay is added to the gradient of conv kernels only, then
  momentum (trace = u + momentum * trace), then -lr * trace, with lr
  ramped linearly over ``warmup_steps``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.detect import iou_matrix
from benchmark.reference.network import _maxpool, _reorg, fp8_round

Tensors = Dict[str, torch.Tensor]


def step_seed(seed: int, step: int) -> int:
    """The augmentation generator's seed of a step (the program's
    ``train/step.py::step_seeds``, first word)."""
    return int(np.random.SeedSequence((seed, step)).generate_state(
        2, np.uint64)[0])


def draws(gen: torch.Generator, n: int, aug: dict, device) -> dict:
    j = aug["jitter"]

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=device)

    z = uniform((n, 2), 1.0 - j, 1.0 + j)
    o = uniform((n, 2), 0.0, 1.0) * torch.abs(1.0 - z)
    o = torch.where(z >= 1.0, -o, o)
    flip = (torch.rand((n,), generator=gen, device=device) < 0.5
            if aug["flip"] else torch.zeros(n, dtype=torch.bool,
                                            device=device))
    dh = uniform((n,), -aug["hue"], aug["hue"])
    log_s, log_v = math.log(aug["saturation"]), math.log(aug["exposure"])
    ds = torch.exp(uniform((n,), -log_s, log_s))
    dv = torch.exp(uniform((n,), -log_v, log_v))
    return {"zoom": z, "offset": o, "flip": flip, "dh": dh, "ds": ds,
            "dv": dv}


def _weights(n_in: int, n_out: int, scale: float, shift: float,
             device) -> torch.Tensor:
    """(n_out, n_in) linear-kernel resampling matrix, antialiased."""
    inv = 1.0 / scale
    ks = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5
              ) * inv - shift * inv - 0.5
    x = (sample[:, None] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[None]).abs() / ks
    w = torch.clamp(1 - x, min=0)
    total = w.sum(1, keepdim=True)
    w = torch.where(total.abs() > 1000 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, 0.0)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb.unbind(-1)
    mx, mn = rgb.amax(-1), rgb.amin(-1)
    d = mx - mn
    dd = torch.where(d > 0, d, 1.0)
    h = torch.where(mx == r, torch.remainder((g - b) / dd, 6.0),
                    torch.where(mx == g, (b - r) / dd + 2.0,
                                (r - g) / dd + 4.0))
    h = torch.where(d > 0, h / 6.0, 0.0)
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, 1.0), 0.0)
    return torch.stack([h, s, mx], -1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv.unbind(-1)
    h6 = torch.remainder(h, 1.0) * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    k = torch.remainder(i, 6).long()
    table = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
             (v, p, q)]
    out = torch.zeros(hsv.shape, dtype=hsv.dtype, device=hsv.device)
    for sector, rgb in enumerate(table):
        out = torch.where((k == sector)[..., None], torch.stack(rgb, -1), out)
    return out


def augment(images: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
            out_dim: int, p: dict, aug: dict):
    """(N, H, W, 3) canvases in [0, 1], boxes (N, G, 4) xywh, valid ->
    the augmented (N, out_dim, out_dim, 3), boxes and valid."""
    n, h, w, _ = images.shape
    z, o = p["zoom"], p["offset"]
    outs = []
    for k in range(n):
        wy = _weights(h, out_dim, float(z[k, 1]) * out_dim / h,
                      float(o[k, 1]) * out_dim, images.device)
        wx = _weights(w, out_dim, float(z[k, 0]) * out_dim / w,
                      float(o[k, 0]) * out_dim, images.device)
        if bool(p["flip"][k]):
            wx = wx.flip(0)
        outs.append(torch.einsum("oh,hwc,pw->opc", wy, images[k] - 0.5,
                                 wx) + 0.5)
    out = torch.stack(outs)
    xy = boxes[..., :2] * z[:, None] + o[:, None]
    wh = boxes[..., 2:] * z[:, None]
    xy = torch.where(p["flip"][:, None, None],
                     torch.stack([1.0 - xy[..., 0], xy[..., 1]], -1), xy)
    lo = torch.clamp(xy - wh / 2, 0.0, 1.0)
    hi = torch.clamp(xy + wh / 2, 0.0, 1.0)
    xy, wh = (lo + hi) / 2, hi - lo
    valid = valid & (wh[..., 0] > aug["min_box"]) & (wh[..., 1] > aug["min_box"])
    hsv = rgb_to_hsv(torch.clamp(out, 0.0, 1.0))
    hsv = torch.stack([
        torch.remainder(hsv[..., 0] + p["dh"][:, None, None], 1.0),
        torch.clamp(hsv[..., 1] * p["ds"][:, None, None], 0.0, 1.0),
        torch.clamp(hsv[..., 2] * p["dv"][:, None, None], 0.0, 1.0)], -1)
    return hsv_to_rgb(hsv), torch.cat([xy, wh], -1), valid


def forward_train(config: dict, params: Tensors, images: torch.Tensor, *,
                  eps: float = 1e-5, round_operands=None) -> torch.Tensor:
    """Train-mode forward: BN normalises with the batch's mean and biased
    variance, gradients flow through both. -> head (N, h, w, A, 5 + C).
    ``round_operands``: ``fp8`` rounds each conv's operands to float8 (the
    control); ``bf16`` rounds them, the conv's output and the layer's
    output to bfloat16, as the program stores them (a witness of what
    bfloat16 alone does to the gradients)."""
    alpha = float(config.get("leaky_alpha", 0.1))
    x = images.float().permute(0, 3, 1, 2)
    outputs: List[torch.Tensor] = []
    for i, layer in enumerate(config["layers"]):
        kind = layer["type"]
        if kind == "conv":
            w = params[f"conv_{i}.w"]
            if round_operands == "fp8":
                x, w = fp8_round(x), fp8_round(w)
            elif round_operands == "bf16":
                x, w = bf16_round(x), bf16_round(w)
            x = F.conv2d(x, w, stride=layer["stride"],
                         padding=layer["size"] // 2)
            if round_operands == "bf16":
                x = bf16_round(x)
            if layer["bn"]:
                m = x.mean(dim=(0, 2, 3), keepdim=True)
                v = torch.square(x - m).mean(dim=(0, 2, 3), keepdim=True)
                x = ((x - m) * torch.rsqrt(v + eps)
                     * params[f"conv_{i}.scale"][None, :, None, None]
                     + params[f"conv_{i}.bias"][None, :, None, None])
            else:
                x = x + params[f"conv_{i}.b"][None, :, None, None]
            if layer["act"] == "leaky":
                x = torch.where(x >= 0, x, alpha * x)
            if round_operands == "bf16":
                x = bf16_round(x)
        elif kind == "maxpool":
            x = _maxpool(x, layer["size"], layer["stride"])
        elif kind == "reorg":
            x = _reorg(x, layer["stride"])
        elif kind == "route":
            x = torch.cat([outputs[r if r >= 0 else i + r]
                           for r in layer["layers"]], dim=1)
        outputs.append(x)
    n, _, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h, w, len(config["anchors"]), -1)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16, back in float32; its gradient is rounded
    to bfloat16 on the way back, as the program's backward holds it."""
    return t.to(torch.bfloat16).float()


def _corners(xy, wh):
    return torch.cat([xy.flip(-1) - wh.flip(-1) / 2,
                      xy.flip(-1) + wh.flip(-1) / 2], -1)


def region_loss(head: torch.Tensor, anchors, gt_xywh: torch.Tensor,
                gt_class: torch.Tensor, gt_valid: torch.Tensor,
                region: dict) -> Tensors:
    """The region loss terms, each summed over an image and averaged over
    the batch, and their sum ``total``."""
    n, h, w, a, _ = head.shape
    c = head.shape[-1] - 5
    dev = head.device
    anc = torch.tensor(anchors, dtype=torch.float32, device=dev)
    scale = torch.tensor([w, h], dtype=torch.float32, device=dev)
    sxy = torch.sigmoid(head[..., 0:2])
    twh = head[..., 2:4]
    conf = torch.sigmoid(head[..., 4])
    probs = torch.softmax(head[..., 5:], -1)
    cy, cx = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    grid = torch.stack([cx, cy], -1)[None, :, :, None]
    pred = _corners((sxy + grid) / scale, anc * torch.exp(twh) / scale)

    obj = torch.zeros((n, h, w, a), device=dev)
    txy_t = torch.zeros((n, h, w, a, 2), device=dev)
    twh_t = torch.zeros((n, h, w, a, 2), device=dev)
    cls_t = torch.zeros((n, h, w, a, c), device=dev)
    cw = torch.zeros((n, h, w, a), device=dev)
    gt_box = torch.zeros((n, h, w, a, 4), device=dev)
    for i in range(n):  # GTs in order: the last one on a slot wins
        for g in torch.nonzero(gt_valid[i]).flatten().tolist():
            xy, wh = gt_xywh[i, g, :2], gt_xywh[i, g, 2:]
            cell = torch.minimum(torch.clamp(torch.floor(xy * scale), min=0),
                                 scale - 1)
            whg = wh * scale
            inter = torch.minimum(whg[None], anc).prod(-1)
            iou = inter / torch.clamp(whg.prod() + anc.prod(-1) - inter,
                                      min=1e-10)
            k = int(torch.argmax(iou))
            u, v = int(cell[0]), int(cell[1])
            obj[i, v, u, k] = 1.0
            txy_t[i, v, u, k] = xy * scale - cell
            twh_t[i, v, u, k] = torch.log(torch.clamp(whg, min=1e-8)
                                          / torch.clamp(anc[k], min=1e-8))
            cls_t[i, v, u, k] = 0.0
            cls_t[i, v, u, k, int(gt_class[i, g])] = 1.0
            cw[i, v, u, k] = 2.0 - wh.prod()
            gt_box[i, v, u, k] = _corners(xy, wh)
    iou_at = torch.diagonal(iou_matrix(pred.reshape(-1, 1, 4),
                                       gt_box.reshape(-1, 1, 4)),
                            dim1=-2, dim2=-1).reshape(n, h, w, a)
    target = iou_at.detach() if region["rescore"] else torch.ones_like(iou_at)
    gts = _corners(gt_xywh[..., :2], gt_xywh[..., 2:])
    best = (iou_matrix(pred.reshape(n, -1, 4), gts)
            * gt_valid.float()[:, None]).amax(-1).reshape(n, h, w, a)
    noobj = (best <= region["thresh"]).float() * (1.0 - obj)

    def per_img(x):
        return x.reshape(n, -1).sum(-1).mean()

    terms = {
        "coord": region["coord_scale"] * per_img(
            (cw * obj)[..., None] * (torch.square(sxy - txy_t)
                                     + torch.square(twh - twh_t))),
        "object": region["object_scale"] * per_img(
            obj * torch.square(conf - target)),
        "noobject": region["noobject_scale"] * per_img(
            noobj * torch.square(conf)),
        "class": region["class_scale"] * per_img(
            obj[..., None] * torch.square(probs - cls_t)),
    }
    terms["total"] = sum(terms.values())
    return terms


def learning_rate(opt: dict, count: int) -> float:
    base, warm = opt["learning_rate"], opt["warmup_steps"]
    if warm and count < warm:
        return base * (count / warm) ** opt.get("warmup_power", 1.0)
    return base


def sgd_momentum(params: Tensors, grads: Tensors, trace: Tensors,
                 opt: dict, count: int) -> Tuple[Tensors, Tensors]:
    """-> (new params, new trace), detached."""
    lr = learning_rate(opt, count)
    new_p, new_t = {}, {}
    for k, p in params.items():
        u = grads[k] + (opt["weight_decay"] * p if p.dim() > 1 else 0.0)
        u = u + opt["momentum"] * trace[k]
        new_t[k] = u.detach()
        new_p[k] = (p - lr * u).detach()
    return new_p, new_t
