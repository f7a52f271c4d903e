"""The int8 trunk's building blocks: the int8 x int8 -> int32 product of a
conv or dense layer, the one-pass requant epilogue's plain version, and the
int8 max-pool.

yolojax leaves the products to XLA (``lax.conv_general_dilated`` and
``dot_general`` with ``preferred_element_type=int32``) and lets XLA fuse
the epilogue after them. Here:

* :func:`int8_conv` is an NHWC im2col copied from a padded, strided int8
  view, its columns ordered (dy, dx, c) to match the HWIO kernel's
  row-major flattening ``w_q.reshape(k*k*cin, cout)``, then
  :func:`int8_matmul`: ``torch._int_mm`` (cuBLASLt igemm with int32 out on
  the card; an exact integer product on the CPU) against the weights kept
  K-major and padded (:func:`gemm_operand`). ``F.conv2d`` is never
  used on int8: on the CPU it returns int8 and wraps around;
* :func:`int8_requant_torch` is the plain version of the CUDA epilogue
  kernel (``csrc/int8_requant.cu``, wrapper ``quantize/cuda_int8.py``);
* :func:`int8_conv_exact` is a float64 conv whose sums are exact, the
  reference the product is held to;
* :func:`int8_max_pool` pads with -128 (``iinfo(int8).min``), as yolojax's
  ``max_pool`` does for integer inputs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# torch._int_mm's shape rules on the card: more than 16 rows, K and N
# multiples of 8. Every product meets them by zero padding.
MIN_ROWS = 17
ALIGN = 8


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


_WORDS = ((8, torch.int64), (4, torch.int32), (2, torch.int16),
          (1, torch.int8))


def im2col(x: torch.Tensor, k: int, stride: int, pad_h: Tuple[int, int],
           pad_w: Tuple[int, int]
           ) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """x (N, H, W, C) int8 NHWC -> (N*Ho*Wo, Kp) int8 with column
    (dy*k + dx)*C + c holding x_padded[n, ho*s + dy, wo*s + dx, c] and
    zero columns from K = k*k*C up to Kp, the next multiple of 8. A 1x1
    stride-1 conv with C % 8 == 0 is a view of ``x``.

    The columns are one copy from a strided view of the padded input,
    moved in the widest word (8, 4, 2 or 1 bytes) that divides C: a
    strided copy of int8 elements runs far below the card's memory rate,
    and the words carry the same bytes."""
    n, h, w, c = x.shape
    ho = (h + pad_h[0] + pad_h[1] - k) // stride + 1
    wo = (w + pad_w[0] + pad_w[1] - k) // stride + 1
    kk = k * k * c
    kp = _round_up(kk, ALIGN)
    if k == 1 and stride == 1 and kp == kk and not any(pad_h + pad_w):
        return x.reshape(n * h * w, c), (n, h, w)
    xp = F.pad(x, (0, 0, pad_w[0], pad_w[1], pad_h[0], pad_h[1])).contiguous()
    cols = torch.empty((n, ho, wo, kp), dtype=x.dtype, device=x.device)
    if kp > kk:
        cols[..., kk:] = 0
    size, word = next((b, t) for b, t in _WORDS
                      if c % b == 0 and xp.storage_offset() % b == 0)
    cw = c // size
    src = xp.view(word)
    s_n, s_h, s_w, _ = src.stride()
    taps = src.as_strided((n, ho, wo, k, k, cw),
                          (s_n, stride * s_h, stride * s_w, s_h, s_w, 1),
                          src.storage_offset())
    cols.view(word)[..., :k * k * cw].view(n, ho, wo, k, k, cw).copy_(taps)
    return cols.reshape(n * ho * wo, kp), (n, ho, wo)


def gemm_operand(w: torch.Tensor) -> torch.Tensor:
    """A (K, N) int8 weight matrix -> the product's B operand as it is
    kept: (Np, Kp) int8 row-major, i.e. B^T, each output column's K values
    contiguous (the K-major layout int8 GEMMs take), zero-padded to
    multiples of 8 in both dimensions."""
    k, n = w.shape
    return F.pad(w.t(), (0, _round_up(k, ALIGN) - k,
                         0, _round_up(n, ALIGN) - n)).contiguous()


def int8_matmul(a: torch.Tensor, bt: torch.Tensor, n: int) -> torch.Tensor:
    """(M, Ka) int8 @ B -> (M, n) int32, exact, for B^T = ``bt`` (Np, Kp)
    from :func:`gemm_operand`. Columns of ``a`` past B's K must be zero
    (:func:`im2col` pads them); ``a`` is zero-padded to Kp columns and past
    16 rows, as ``torch._int_mm`` wants on the card. The result is a
    column slice of the (M, Np) product when n < Np."""
    m, ka = a.shape
    kp = bt.shape[1]
    if ka < kp or m < MIN_ROWS:
        a = F.pad(a, (0, kp - ka, 0, max(MIN_ROWS - m, 0)))
    return torch._int_mm(a.contiguous(), bt.t())[:m, :n]


def int8_conv(x: torch.Tensor, w_q: torch.Tensor, stride: int,
              pad_h: Tuple[int, int], pad_w: Tuple[int, int], *,
              operand: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """NHWC int8 x (N, H, W, Cin) times HWIO int8 ``w_q`` (k, k, Cin, Cout)
    -> the int32 sums as a (N*Ho*Wo, Cout) matrix, and (N, Ho, Wo).
    ``operand`` is ``gemm_operand(w_q.reshape(k*k*Cin, Cout))`` when the
    caller keeps it."""
    k, _, cin, cout = w_q.shape
    if operand is None:
        operand = gemm_operand(w_q.reshape(k * k * cin, cout))
    cols, shape = im2col(x, k, stride, pad_h, pad_w)
    return int8_matmul(cols, operand, cout), shape


def int8_conv_exact(x: torch.Tensor, w_q: torch.Tensor, stride: int,
                    pad_h: Tuple[int, int], pad_w: Tuple[int, int]
                    ) -> torch.Tensor:
    """The int32 sums of :func:`int8_conv` as a float64 conv on the CPU,
    (N, Ho, Wo, Cout) int32. Exact: every partial sum is an integer below
    127 * 127 * k*k*Cin < 2^53."""
    xd = F.pad(x.cpu().double(),
               (0, 0, pad_w[0], pad_w[1], pad_h[0], pad_h[1]))
    wd = w_q.cpu().double().permute(3, 2, 0, 1)  # HWIO -> OIHW
    y = F.conv2d(xd.permute(0, 3, 1, 2), wd, stride=stride)
    return y.permute(0, 2, 3, 1).round().to(torch.int32)


def fma_f32(a: torch.Tensor, m: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fmaf(a, m, b) elementwise for f32 tensors: a * m + b rounded once
    to f32, as one fused multiply-add (``__fmaf_rn``) gives it.

    The product of two f32 values has at most 48 significant bits, so it
    is exact in float64. Rounding the float64 sum s = fl64(p + b) to f32
    is a second rounding, and it can differ from rounding p + b once: when
    s lands exactly halfway between two f32 neighbours while the sum's
    error e = (p + b) - s (TwoSum, exact) is not zero, the exact value lies
    on e's side of that midpoint and ties-to-even may go the other way. In
    every other case s and p + b round to the same f32 (the midpoints are
    float64 values, and s is the float64 nearest p + b). So the midpoints
    with e != 0 are rounded toward e, everything else as s rounds."""
    p = a.double() * m.double()
    bd = b.double()
    s = p + bd
    bv = s - p
    e = (p - (s - bv)) + (bd - bv)
    t = s.float()
    up = t.double() > s
    inf = torch.full_like(t, math.inf)
    hi = torch.where(up, t, torch.nextafter(t, inf))
    lo = torch.where(up, torch.nextafter(t, -inf), t)
    mid = (s - lo.double()) == (hi.double() - s)
    return torch.where(mid & (e != 0), torch.where(e > 0, hi, lo), t)


def requant_codes(y: torch.Tensor, r: float, qmax: int) -> torch.Tensor:
    """f32 -> int8 codes: round(y * r) half to even, clamped to +-qmax.
    ``r`` = f32(1) / f32(scale), the reciprocal jitted XLA multiplies by
    in place of yolojax's ``y / scale``. ``r`` is an f32 value, so the
    scalar multiply is one f32 multiply on the CPU and on the card."""
    q = torch.round(y * r)
    return q.clamp_(-qmax, qmax).to(torch.int8)


def int8_requant_torch(acc: torch.Tensor, m: torch.Tensor, b: torch.Tensor,
                       r: float, qmax: int, leaky: bool,
                       phases: int = 1) -> torch.Tensor:
    """Plain version of the requant kernel. acc (M, phases*C) int32, m and
    b (phases*C,) f32 -> (M, C) int8:

        y = fma(f32(acc), m[col], b[col]); y = y >= 0 ? y : f32(0.1) * y
        (when ``leaky``); q = clamp(rint(y * r), -qmax, qmax)

    then, with ``phases`` = 4, the max over the four phase groups of C
    columns (the fused int8 stem's pool)."""
    y = fma_f32(acc.float(), m, b)
    if leaky:
        y = torch.where(y >= 0, y, y * 0.1)  # the scalar rounds to f32(0.1)
    q = requant_codes(y, r, qmax)
    if phases > 1:
        q = q.reshape(q.shape[0], phases, -1).amax(dim=1)
    return q


def int8_max_pool(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """Max pool of an int8 NHWC tensor with yolojax's SAME-style split
    padding, filled with -128: the max over ``size``**2 strided slices.
    Tiny-YOLOv2's ``MaxPoolSpec(2, 1)`` pads (0, 1)."""
    n, h, w, c = x.shape
    total_h = max((math.ceil(h / stride) - 1) * stride + size - h, 0)
    total_w = max((math.ceil(w / stride) - 1) * stride + size - w, 0)
    if total_h or total_w:
        x = F.pad(x, (0, 0, total_w // 2, total_w - total_w // 2,
                      total_h // 2, total_h - total_h // 2),
                  value=torch.iinfo(torch.int8).min)
    ho = (x.shape[1] - size) // stride + 1
    wo = (x.shape[2] - size) // stride + 1
    out = None
    for dy in range(size):
        for dx in range(size):
            win = x[:, dy:dy + stride * (ho - 1) + 1:stride,
                    dx:dx + stride * (wo - 1) + 1:stride]
            out = win.clone() if out is None else torch.maximum(out, win)
    return out
