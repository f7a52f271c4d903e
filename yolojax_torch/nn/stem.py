"""Fused first conv + max-pool "stem" for inference.

Port of ``yolojax/nn/stem.py``. The opening ``conv 3x3, 3 -> Co, stride 1``
of a BN-folded YOLOv2 backbone, its bias + leaky and the 2x2/2 max-pool
after it become one :class:`StemSpec`:

    out(a, b, co) = max over (di, dj) in {0,1}^2 of
        leaky(b[co] + sum_{u,v,c} w0[u,v,c,co] * x[2a+di+u-1, 2b+dj+v-1, c])

with zero padding. leaky is monotone, so taking it before the max is the
same as conv -> bias -> leaky -> pool. yolojax phase-packs the conv for the
TPU's matrix unit: the input goes space-to-depth to (H/2, W/2, 4*Ci) and
the kernel to (3, 3, 4*Ci, 4*Co) (:func:`pack_stem_kernel`), one 3x3 conv
on the packed grid then gives the four pool phases as four channel groups.

Here:

* :func:`stem_forward` is that packed conv, the counterpart of yolojax's
  XLA branch (``detect.fuse_stem=xla``);
* :func:`stem_fused_torch` is the plain version of the CUDA kernel
  (``nn/cuda_stem.py``, ``csrc/stem_fused.cu``), with the rounding points
  of ``yolojax/nn/pallas_stem.py::stem_forward_pallas``;
* :func:`fuse_stem` is the graph surgery, with yolojax's declines.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from yolojax_torch.nn.layers import (
    ConvSpec,
    MaxPoolSpec,
    Network,
    StemLayer,
    leaky_relu,
    space_to_depth,
)

IMPLS = ("off", "auto", "pallas", "xla")


@dataclasses.dataclass(frozen=True)
class StemSpec:
    """Marker spec: fused conv0 + bias + leaky + 2x2/2 max-pool.

    Lives at spec index 0; the original MaxPoolSpec slot is replaced by a
    NoOpSpec so later conv_{i} names and route indices keep their values.

    impl: "auto" or "pallas" (the CUDA kernel on the card, its plain version
    on the CPU), or "xla" (the packed conv, :func:`stem_forward`).
    """

    out: int  # original conv0 output channels (e.g. 32)
    impl: str = "auto"


@dataclasses.dataclass(frozen=True)
class NoOpSpec:
    """Placeholder keeping spec indices stable after fusion."""


def pack_stem_kernel(w0: np.ndarray) -> np.ndarray:
    """(3,3,3,Co) conv kernel -> (3,3,4*Ci,4*Co) packed phase kernel."""
    k, k2, ci, co = w0.shape
    assert k == 3 and k2 == 3, "stem fusion requires a 3x3 first conv"
    w0 = np.asarray(w0, np.float32)
    wp = np.zeros((3, 3, 4 * ci, 4 * co), np.float32)
    for di in range(2):
        for dj in range(2):
            for u in range(3):
                ar, si = divmod(di + u - 1, 2)
                for v in range(3):
                    ac, sj = divmod(dj + v - 1, 2)
                    pc = (si * 2 + sj) * ci
                    po = (di * 2 + dj) * co
                    wp[ar + 1, ac + 1, pc : pc + ci, po : po + co] = w0[u, v]
    return wp


def unpack_stem_kernel(wp: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`pack_stem_kernel`: (3,3,4*Ci,4*Co) -> w0
    (3,3,Ci,Co). Phase (0,0)'s channel group holds all nine taps."""
    ci, co = wp.shape[2] // 4, wp.shape[3] // 4
    rows = []
    for u in range(3):
        ar, si = divmod(u - 1, 2)
        taps = []
        for v in range(3):
            ac, sj = divmod(v - 1, 2)
            pc = (si * 2 + sj) * ci
            taps.append(wp[ar + 1, ac + 1, pc : pc + ci, :co])
        rows.append(torch.stack(taps))
    return torch.stack(rows)


def stem_forward(x: torch.Tensor, wp: torch.Tensor, b: torch.Tensor, *,
                 compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """images (N, H, W, Ci) -> fused conv0+leaky+pool output
    (N, H/2, W/2, Co) in ``compute_dtype``, through the packed conv. The
    conv output is rounded to ``compute_dtype`` before the f32 bias, as in
    yolojax's ``stem_forward``."""
    n, h, w, _ = x.shape
    co = b.shape[0]
    xp = space_to_depth(x.to(compute_dtype), 2)  # (N, H/2, W/2, 4*Ci)
    y = F.conv2d(xp.permute(0, 3, 1, 2),
                 wp.to(compute_dtype).permute(3, 2, 0, 1),  # HWIO -> OIHW
                 padding=1)  # darknet pad on the packed grid
    yf = y.permute(0, 2, 3, 1).float() + b.float().repeat(4)
    yf = leaky_relu(yf)
    # phase-max == the original 2x2/2 max-pool (phases are the pool window)
    yf = yf.reshape(n, h // 2, w // 2, 4, co).amax(dim=3)
    return yf.to(compute_dtype)


def stem_fused_torch(x: torch.Tensor, wp: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """Plain version of the stem kernel: (N, H, W, 3) float ->
    (N, H/2, W/2, Co) bf16 NHWC.

    The rounding points of ``stem_forward_pallas``: x and wp rounded to
    bf16, the packed conv summed in f32, the tiled bias added to the f32
    sum, leaky and the phase max in f32, one rounding to bf16 at the end.
    The sum runs tap by tap, packed channel by packed channel, one f32
    multiply and one f32 add each: the CUDA kernel adds the same products
    in the same order (it skips the packed kernel's zeros, which add
    nothing), so the two agree bit for bit.
    """
    n, h, w, _ = x.shape
    co = b.shape[0]
    p, q = h // 2, w // 2
    xb = x.to(torch.bfloat16).float()
    wb = wp.to(torch.bfloat16).float()
    # space-to-depth, then the zero pad of 1 on the packed grid
    xp = F.pad(space_to_depth(xb, 2), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((n, p, q, wb.shape[3]), dtype=torch.float32,
                      device=x.device)
    for u in range(3):
        for v in range(3):
            win = xp[:, u : u + p, v : v + q, :]
            for pc in range(wb.shape[2]):
                acc += win[..., pc : pc + 1] * wb[u, v, pc]
    z = leaky_relu(acc + b.float().repeat(4))
    return z.reshape(n, p, q, 4, co).amax(dim=3).to(torch.bfloat16)


def fuse_stem(model, net: Network, impl: str = "off"):
    """Graph surgery (inference only): fold conv0 + pool1 into a StemSpec.

    Requires a BN-folded model (run
    :func:`yolojax_torch.convert.fold.fold_bn` first). Returns
    (model', net') or the inputs unchanged when ``impl`` is "off" or the
    opening pattern does not match (conv 3x3 s1 leaky without BN, then pool
    2x2 s2, then a conv): YOLOv1's 7x7/s2 opening and an unfolded model are
    declined, as in yolojax. Layers other than conv_0 are shared with
    ``net``.
    """
    if impl not in IMPLS:
        raise ValueError(f"fuse_stem impl {impl!r}: expected one of {IMPLS}")
    if impl == "off":
        return model, net
    specs = model.specs
    if len(specs) < 3:
        return model, net
    c0, p1 = specs[0], specs[1]
    if not (
        isinstance(c0, ConvSpec)
        and c0.ksize == 3
        and c0.stride == 1
        and not c0.bn
        and c0.act == "leaky"
        and isinstance(p1, MaxPoolSpec)
        and p1.size == 2
        and p1.stride == 2
        and isinstance(specs[2], ConvSpec)
    ):
        return model, net
    conv0 = net.conv_0
    w0 = conv0.w.detach().float().permute(2, 3, 1, 0).cpu().numpy()  # HWIO
    layers = dict(net.named_children())
    layers["conv_0"] = StemLayer(
        torch.from_numpy(pack_stem_kernel(w0)).to(conv0.w.device),
        conv0.b.detach().float().clone())
    new_specs = (StemSpec(out=c0.out, impl=impl), NoOpSpec()) + tuple(specs[2:])
    new_model = dataclasses.replace(model, specs=new_specs)
    return new_model, Network(new_specs, layers)
