"""Training-time augmentation on the device, and the letterbox resize.

Port of ``yolojax/data/augment.py``. The augmentation (random zoom and
translate, horizontal flip, HSV jitter) is split into a *draw* of each
image's parameters from a ``torch.Generator`` (:func:`draw_params`, with
yolojax's ranges) and a deterministic *apply* of those parameters
(:func:`apply_geometry`, :func:`apply_color_jitter`), so the apply is held
against yolojax exactly while the random bits, which JAX's generator makes
and PyTorch's cannot repeat, are held to their ranges only.

The resample is ``jax.image.scale_and_translate(method="linear")``, whose
triangle kernel widens by 1/scale when it downsamples (antialiasing):
:func:`resample_weights` builds its separable weight matrices as JAX's
``compute_weight_mat`` does, and :func:`scale_and_translate` applies them
with two batched products. ``F.interpolate`` computes other weights.

Geometry convention: boxes are (cx, cy, w, h), normalised to the canvas;
the zoom is x' = x * z + o. The gray fill outside the source is the
(img - 0.5) ... + 0.5 trick: the resample fills zeros, which map back to
0.5 gray.

The letterbox (:func:`letterbox_host`) is ``F.interpolate`` (bilinear,
``align_corners=False``, no antialias), which computes what
``cv2.resize(INTER_LINEAR)`` computes on float images; the port does not
need cv2.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Darknet-style jitter parameters (``[data_augmentation]``; defaults
    match yolo-voc.cfg)."""

    flip: bool = True
    jitter: float = 0.2      # max relative crop/zoom perturbation
    hue: float = 0.1         # max hue rotation (fraction of the wheel)
    saturation: float = 1.5  # max saturation scale (sampled in [1/s, s])
    exposure: float = 1.5    # max value/exposure scale (sampled in [1/s, s])
    min_box: float = 0.003   # boxes smaller than this after crop are dropped


# ---------------------------------------------------------------------------
# Color space
# ---------------------------------------------------------------------------


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] -> HSV, h in [0, 1)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.amax(rgb, dim=-1)
    mn = torch.amin(rgb, dim=-1)
    d = mx - mn
    safe_d = torch.where(d > 0, d, 1.0)
    h = torch.where(
        mx == r,
        torch.remainder((g - b) / safe_d, 6.0),
        torch.where(mx == g, (b - r) / safe_d + 2.0, (r - g) / safe_d + 4.0),
    )
    h = torch.where(d > 0, h / 6.0, 0.0)
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, 1.0), 0.0)
    return torch.stack([h, s, mx], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h6 = torch.remainder(h, 1.0) * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    sector = torch.remainder(i.to(torch.int32), 6).long()[..., None]

    def pick(*choices):
        return torch.gather(torch.stack(choices, dim=-1), -1, sector)[..., 0]

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AugmentParams:
    """Per-image augmentation parameters, f32 on the batch's device."""

    zoom: torch.Tensor    # (N, 2) (zx, zy) in [1 - jitter, 1 + jitter]
    offset: torch.Tensor  # (N, 2) (ox, oy): shift left/up on zoom-in, pad out
    flip: torch.Tensor    # (N,) bool
    dh: torch.Tensor      # (N,) hue rotation in [-hue, hue]
    ds: torch.Tensor      # (N,) saturation scale in [1/s, s]
    dv: torch.Tensor      # (N,) exposure scale in [1/e, e]


def _uniform(generator, shape, lo, hi, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return lo + (hi - lo) * u


def draw_params(generator: torch.Generator, n: int, cfg: AugmentConfig,
                device=None) -> AugmentParams:
    """Draw ``n`` images' parameters from ``generator`` (on ``device``)."""
    j = cfg.jitter
    z = _uniform(generator, (n, 2), 1.0 - j, 1.0 + j, device)
    o = _uniform(generator, (n, 2), 0.0, 1.0, device) * torch.abs(1.0 - z)
    o = torch.where(z >= 1.0, -o, o)  # zoom-in: shift left/up; zoom-out: pad
    if cfg.flip:
        flip = torch.rand((n,), generator=generator, device=device) < 0.5
    else:
        flip = torch.zeros((n,), dtype=torch.bool, device=device)
    dh = _uniform(generator, (n,), -cfg.hue, cfg.hue, device)
    # saturation/exposure sample in [1/s, s]; a value <= 0 (an "off" typo
    # in the INI) disables the jitter, as log(0) would poison training
    log_s = math.log(cfg.saturation if cfg.saturation > 0 else 1.0)
    log_v = math.log(cfg.exposure if cfg.exposure > 0 else 1.0)
    ds = torch.exp(_uniform(generator, (n,), -log_s, log_s, device))
    dv = torch.exp(_uniform(generator, (n,), -log_v, log_v, device))
    return AugmentParams(z, o, flip, dh, ds, dv)


# ---------------------------------------------------------------------------
# Resample (jax.image.scale_and_translate, method="linear")
# ---------------------------------------------------------------------------


def resample_weights(in_size: int, out_size: int, scale: torch.Tensor,
                     translation: torch.Tensor) -> torch.Tensor:
    """JAX's ``compute_weight_mat`` for the linear kernel with antialias,
    batched: (N,) scale and translation -> (N, in_size, out_size) f32."""
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=dev)
                 + 0.5)[None, :] * inv_scale[:, None]
                - (translation * inv_scale)[:, None] - 0.5)  # (N, out)
    x = (torch.abs(sample_f[:, None, :]
                   - torch.arange(in_size, dtype=torch.float32,
                                  device=dev)[None, :, None])
         / kernel_scale[:, None, None])
    weights = torch.clamp(1 - torch.abs(x), min=0)
    total = torch.sum(weights, dim=1, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


def scale_and_translate(images: torch.Tensor, out_hw: Tuple[int, int],
                        scale: torch.Tensor, translation: torch.Tensor,
                        flip: torch.Tensor = None) -> torch.Tensor:
    """Resample (N, H, W, C) images to (N, out_h, out_w, C): ``scale`` and
    ``translation`` are (N, 2) over (y, x), as yolojax passes them. The
    weights take the images' dtype, as in JAX. ``flip`` (N,) mirrors an
    image's output columns by reversing its x weights, which computes the
    same numbers as flipping the output."""
    n, h, w, c = images.shape
    oh, ow = out_hw
    dtype = images.dtype
    wy = resample_weights(h, oh, scale[:, 0], translation[:, 0])
    wx = resample_weights(w, ow, scale[:, 1], translation[:, 1])
    wy = wy.transpose(1, 2).to(dtype)  # (N, oh, H)
    wx = wx.transpose(1, 2)  # (N, ow, W)
    if flip is not None:
        wx = torch.where(flip[:, None, None], wx.flip(1), wx)
    wx = wx.to(dtype)
    t = torch.bmm(wy, images.reshape(n, h, w * c)).reshape(n, oh, w, c)
    t = t.permute(0, 2, 1, 3).reshape(n, w, oh * c)
    out = torch.bmm(wx, t).reshape(n, ow, oh, c)
    return out.permute(0, 2, 1, 3).contiguous()


def resize(images: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.image.resize(images, (N, dim, dim, C), "linear")``."""
    n, h, w, _ = images.shape
    scale = torch.stack([torch.full((n,), dim / h, device=images.device),
                         torch.full((n,), dim / w, device=images.device)], -1)
    return scale_and_translate(images, (dim, dim), scale,
                               torch.zeros_like(scale))


# ---------------------------------------------------------------------------
# Applies
# ---------------------------------------------------------------------------


def apply_geometry(images: torch.Tensor, boxes: torch.Tensor,
                   valid: torch.Tensor, out_dim: int, params: AugmentParams,
                   cfg: AugmentConfig = AugmentConfig()):
    """Zoom/translate then flip each image and its boxes; boxes are clipped
    to the frame and those thinner than ``cfg.min_box`` become invalid."""
    h_in, w_in = images.shape[1], images.shape[2]
    z, o = params.zoom, params.offset
    scale = torch.stack([z[:, 1] * out_dim / float(h_in),
                         z[:, 0] * out_dim / float(w_in)], dim=-1)
    trans = torch.stack([o[:, 1], o[:, 0]], dim=-1) * out_dim
    images = scale_and_translate(images - 0.5, (out_dim, out_dim), scale,
                                 trans, flip=params.flip) + 0.5

    boxes = boxes.float()
    xy = boxes[..., 0:2] * z[:, None, :] + o[:, None, :]
    wh = boxes[..., 2:4] * z[:, None, :]
    xy = torch.where(params.flip[:, None, None],
                     torch.stack([1.0 - xy[..., 0], xy[..., 1]], -1), xy)
    lo = torch.clamp(xy - wh / 2, 0.0, 1.0)
    hi = torch.clamp(xy + wh / 2, 0.0, 1.0)
    xy = (lo + hi) / 2
    wh = hi - lo
    valid = valid & (wh[..., 0] > cfg.min_box) & (wh[..., 1] > cfg.min_box)
    return images, torch.cat([xy, wh], -1), valid


def apply_color_jitter(images: torch.Tensor,
                       params: AugmentParams) -> torch.Tensor:
    """HSV jitter: hue rotated by ``dh`` (mod 1), saturation and value
    scaled by ``ds`` / ``dv`` and clipped to [0, 1]. The f32 parameters
    promote the result to f32, as in yolojax."""
    hsv = rgb_to_hsv(torch.clamp(images, 0.0, 1.0))
    hsv = torch.stack([
        torch.remainder(hsv[..., 0] + params.dh[:, None, None], 1.0),
        torch.clamp(hsv[..., 1] * params.ds[:, None, None], 0.0, 1.0),
        torch.clamp(hsv[..., 2] * params.dv[:, None, None], 0.0, 1.0),
    ], dim=-1)
    return hsv_to_rgb(hsv)


def augment_batch(generator: torch.Generator, images: torch.Tensor,
                  boxes: torch.Tensor, valid: torch.Tensor, out_dim: int,
                  cfg: AugmentConfig = AugmentConfig(),
                  rows: Optional[Tuple[int, int]] = None):
    """Draw per-image parameters from ``generator`` and apply them:
    (N, H, W, 3) canvases in [0, 1] -> (N, out_dim, out_dim, 3), boxes
    (N, G, 4) xywh and valid (N, G) moved with them. ``rows`` = (first
    row, global rows): the images are rows ``first .. first + N`` of a
    global batch, and get the draws of those rows of the global batch's
    draw (a data-parallel rank's share of one device's step)."""
    n = images.shape[0]
    if rows is None:
        params = draw_params(generator, n, cfg, images.device)
    else:
        full = draw_params(generator, rows[1], cfg, images.device)
        params = AugmentParams(**{
            f.name: getattr(full, f.name)[rows[0]: rows[0] + n]
            for f in dataclasses.fields(AugmentParams)})
    images, boxes, valid = apply_geometry(images, boxes, valid, out_dim,
                                          params, cfg)
    return apply_color_jitter(images, params), boxes, valid


# ---------------------------------------------------------------------------
# Letterbox (detect-time and loader preprocessing)
# ---------------------------------------------------------------------------


def letterbox_transform(
    w: int, h: int, dim: int, *, stretch: bool = False
) -> Tuple[float, float, float, float]:
    """The pure box transform of :func:`letterbox_host` for a (w, h) source:
    (scale_x, scale_y, pad_x, pad_y), normalized, with
    box_canvas = box_image * scale + pad.
    """
    if stretch:
        return (1.0, 1.0, 0.0, 0.0)
    r = min(dim / w, dim / h)
    nw, nh = int(round(w * r)), int(round(h * r))
    px, py = (dim - nw) // 2, (dim - nh) // 2
    return (nw / dim, nh / dim, px / dim, py / dim)


def _resize(img: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(H, W, C) float -> (size[0], size[1], C), bilinear, half-pixel."""
    out = F.interpolate(img.permute(2, 0, 1)[None], size=size,
                        mode="bilinear", align_corners=False, antialias=False)
    return out[0].permute(1, 2, 0)


def letterbox_host(
    img: Union[np.ndarray, torch.Tensor], dim: int, *, stretch: bool = False
) -> Tuple[torch.Tensor, Tuple[float, float, float, float]]:
    """Resize an HWC uint8/float RGB image to (dim, dim), aspect-preserving
    with 0.5-gray padding (or plain stretch).

    Returns (canvas float32 (dim, dim, 3) in [0, 1] on the image's device,
    (scale_x, scale_y, pad_x, pad_y)) where box_canvas = box_image * scale
    + pad, all normalized.
    """
    img = torch.as_tensor(img)
    h, w = img.shape[:2]
    img = img.float() / 255.0 if img.dtype == torch.uint8 else img.float()
    if stretch:
        return (_resize(img, (dim, dim)),
                letterbox_transform(w, h, dim, stretch=True))
    sx, sy, pxn, pyn = letterbox_transform(w, h, dim)
    nw, nh = int(round(sx * dim)), int(round(sy * dim))
    px, py = int(round(pxn * dim)), int(round(pyn * dim))
    canvas = torch.full((dim, dim, 3), 0.5, dtype=torch.float32,
                        device=img.device)
    canvas[py: py + nh, px: px + nw] = _resize(img, (nh, nw))
    return canvas, (sx, sy, pxn, pyn)
