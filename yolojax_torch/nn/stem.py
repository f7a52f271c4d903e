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
  of ``yolojax/nn/pallas_stem.py::stem_forward_pallas``; the kernel sums
  on the tensor cores in another order and is held to it within
  :func:`stem_tolerance`, not bit for bit;
* :data:`STEM_K_TAPS` and :func:`stem_mma_operand` are the kernel's GEMM
  layout: which tap each K index carries, and the B operand in the
  per-lane fragment order of ``mma.sync m16n8k16``;
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
    multiply and one f32 add each. The CUDA kernel forms the same exact
    bf16 products but sums them on the tensor cores in their own order, so
    it agrees with this version within :func:`stem_tolerance`.
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


def _k_taps():
    """K index -> tap (u, v, c) of the CUDA kernel's GEMM, None for the
    five zero rows that pad 27 taps to 32. K slots 2p and 2p + 1 hold tap
    pair p = 5u + j/2: taps j and j + 1 (j = v*3 + c even) of tap row u,
    which are two neighbouring floats of one staged input row, so each pair
    is one aligned 32-bit load of bf16 pairs in the kernel. j + 1 = 9 (the
    next pixel's first value) and pair 15 are padding. In ``mma.sync
    m16n8k16`` lane group ``tig`` (lane % 4) holds pairs p = 4q + tig,
    q = 0..3 over the two k-steps."""
    taps = [None] * 32
    for p in range(15):
        u, j0 = divmod(p, 5)
        for e in range(2):
            j = 2 * j0 + e
            if j < 9:
                taps[2 * p + e] = (u, j // 3, j % 3)
    return tuple(taps)


STEM_K_TAPS = _k_taps()


def stem_mma_matrix(w0: torch.Tensor) -> torch.Tensor:
    """The kernel's B operand as a matrix: (32, Co) f32 holding the
    bf16-rounded w0 (3, 3, 3, Co) in the K order of :data:`STEM_K_TAPS`,
    zero rows for padding."""
    wb = w0.detach().to(torch.bfloat16).float()
    zero = torch.zeros(wb.shape[3], dtype=torch.float32, device=wb.device)
    return torch.stack([zero if t is None else wb[t] for t in STEM_K_TAPS])


def stem_mma_operand(w0: torch.Tensor) -> torch.Tensor:
    """B in the per-lane fragment order the CUDA kernel loads: (16, 32)
    int32, register r = (ks*4 + nt)*2 + half of lane l holds the bf16 pair
    B[k0, n], B[k0 + 1, n] (low half first) with k0 = 16*ks + 8*half +
    2*(l % 4) and n = 8*nt + l // 4, as ``mma.sync m16n8k16``'s col-major B
    fragment wants it. Co must be 32."""
    bits = stem_mma_matrix(w0).to(torch.bfloat16).view(torch.int16)
    bits = bits.to(torch.int64) & 0xFFFF
    lane = torch.arange(32, device=bits.device)
    g, tig = lane // 4, lane % 4
    regs = []
    for ks in range(2):
        for nt in range(4):
            for half in range(2):
                k0 = 16 * ks + 8 * half + 2 * tig
                n = 8 * nt + g
                regs.append(bits[k0, n] | (bits[k0 + 1, n] << 16))
    word = torch.stack(regs)
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)


def stem_tolerance(x: torch.Tensor, w0: torch.Tensor, b: torch.Tensor,
                   want: torch.Tensor) -> torch.Tensor:
    """How far the CUDA stem kernel may be from :func:`stem_fused_torch`'s
    ``want`` (N, H/2, W/2, Co), elementwise:

        ulp_bf16(want) + 2^-17 * (|b[co]| + max|x| * sum_{u,v,c} |w0_bf16[u,v,c,co]|)

    The products are exact in f32 on both sides; only the order of the 27
    additions differs. Each addition is off by at most one f32 ulp of the
    running magnitude (2^-23 of the sum of |terms|, even if the tensor core
    truncates), so 27 of them stay within 27 * 2^-23 * sum|terms|; the
    factor 2^-17 = 64 * 2^-23 is that with a margin of 2. The final bf16
    rounding can add one ulp. Bias, leaky and max pass the error on without
    growing it."""
    wb = w0.detach().to(torch.bfloat16).float()
    xmax = x.detach().to(torch.bfloat16).float().abs().max()
    terms = b.detach().float().abs() + xmax * wb.abs().sum(dim=(0, 1, 2))
    wf = want.float()
    _, e = torch.frexp(wf)
    ulp = torch.where(wf == 0, torch.full_like(wf, 2.0 ** -133),
                      torch.ldexp(torch.ones_like(wf), e - 8))
    return ulp + 2.0 ** -17 * terms


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
