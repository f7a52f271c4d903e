"""Wrappers of the train-mode epilogue kernels (``csrc/bn_train.cu``).

Replace what XLA fuses around the train-mode epilogue of
``yolojax/nn/layers.py::apply_network`` (``layers.py:397-420``) and its
VJP: the batch statistics of BN and the backward of BN (or bias) + leaky +
the cast to bf16. The forward's normalise + leaky + cast is the
``conv_epilogue`` kernel (``nn/cuda_epilogue.py``); the autograd Function
that strings them together is ``nn/train_epilogue.py``. The kernels are
bound by bytes (see the note at the top of the source).

Each wrapper checks its arguments and calls its custom operator
(``kernels/ops.py``): for a CUDA tensor the operator launches the kernel
through this module's ``launch_*`` and raises on what it does not take;
for a CPU tensor it runs the plain version (``nn/layers.py``). There is no
fallback from one to the other. The kernels read rows of contiguous
channels at one row stride, so a column slice of a wider gradient (the
route's ``torch.cat`` backward) is taken as it is; :func:`rows_of_grad`
copies any other gradient layout once and counts the copy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from yolojax_torch.kernels import build, ops
from yolojax_torch.nn.cuda_epilogue import _rows, row_stride

# every step is a round-to-nearest intrinsic: nothing left to contract
NVCC_FLAGS = ()
THREADS = 256    # a reduction block's threads
MAX_UNITS = 32   # channel vectors a reduction block covers
MAX_TERMS = 256  # values one thread sums in f32 before the block's sum
BLOCKS_PER_SM = 8
# the sums' error against a float64 sum of the same f32 terms, of the sum
# of their magnitudes: a thread adds at most MAX_TERMS values, a block at
# most THREADS lanes, each in f32 (one rounding an addition); the partials
# are added in float64 and rounded once
SUM_RTOL = (MAX_TERMS + THREADS + 1) * 2.0 ** -24


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = build.load("bn_train", NVCC_FLAGS)
    p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float)
    sums = lib.bn_sums_launch
    sums.argtypes = [p, ll, p, ll, i, ll, i, i, p, p, p]
    grad_sums = lib.grad_sums_launch
    grad_sums.argtypes = [p, ll, p, ll, p, p, p, p, f, i, ll, i, ll, i, i, p,
                          p, p]
    apply = lib.grad_apply_launch
    apply.argtypes = [p, ll, p, ll, p, p, p, p, p, p, f, i, ll, i, p, p]
    for fn in (sums, grad_sums, apply):
        fn.restype = ctypes.c_int
    err = lib.bn_train_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return sums, grad_sums, apply, err


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sums_geometry(rows: int, channels: int, vec: int,
                  sms: int) -> Tuple[int, int, int, int]:
    """The reduction grid: ``(tiles, lanes, chunk_rows, chunks)``. A block
    covers ``min(C / vec, 32)`` channel vectors and THREADS / that many
    row lanes; the rows are cut into ``chunks`` of ``chunk_rows`` (none
    empty), enough for BLOCKS_PER_SM blocks an SM but no more than one row
    a lane, and never so few that a thread sums more than MAX_TERMS
    values."""
    units = channels // vec
    tile_units = min(units, MAX_UNITS)
    tiles = -(-units // tile_units)
    lanes = THREADS // tile_units
    chunks = min(-(-sms * BLOCKS_PER_SM // tiles), -(-rows // lanes))
    chunks = max(chunks, -(-rows // (lanes * MAX_TERMS)), 1)
    chunk_rows = -(-rows // chunks)
    return tiles, lanes, chunk_rows, -(-rows // chunk_rows)


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def _check_vectors(c: int, device, **vectors) -> None:
    for name, t in vectors.items():
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (c,)
                              or t.device != device or not t.is_contiguous()):
            raise ValueError(f"cuda_bn_train: want {name} ({c},) float32 "
                             f"contiguous on {device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")


def _check_y(y: torch.Tensor, what: str = "y") -> None:
    if y.dtype != torch.bfloat16 or y.dim() < 2:
        raise ValueError(f"cuda_bn_train: want {what} (..., C) bfloat16, got "
                         f"{tuple(y.shape)} {y.dtype}")
    _rows(y)


def _device_ok(y: torch.Tensor) -> bool:
    """Whether the wrapper checks the kernel's limits: a real CUDA tensor
    (the plain version takes anything on the CPU)."""
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cuda_bn_train: y on {y.device}; want a CUDA device "
                         "(or the CPU for the plain version)")
    return y.device.type == "cuda" and not torch.compiler.is_compiling()


def rows_of_grad(g: torch.Tensor) -> torch.Tensor:
    """The gradient of the epilogue's output as the kernels read it: on the
    card, rows of contiguous channels at one row stride (a column slice is
    taken as it is), else one ``.contiguous()`` copy, counted in
    ``rows_of_grad.copies``. On the CPU, ``g`` as it is."""
    if g.device.type != "cuda":
        return g
    try:
        _rows(g)
        return g
    except ValueError:
        rows_of_grad.copies += 1
        return g.contiguous()


rows_of_grad.copies = 0  # gradients copied to rows since the last reset


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def bn_channel_sums_cuda(y: torch.Tensor,
                         m: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y (..., C) bf16 -> (C,) f32: Σy, or Σ(y - m)² given the mean ``m``
    (see :func:`yolojax_torch.nn.layers.bn_channel_sums_torch`)."""
    if _device_ok(y):
        _check_y(y)
        _check_vectors(y.shape[-1], y.device, m=m)
    return ops.bn_channel_sums(y, m)


def epilogue_grad_sums_cuda(g: torch.Tensor, y: torch.Tensor, inv, shift,
                            m, rstd, *, leaky: bool,
                            alpha: float = 0.1) -> torch.Tensor:
    """The backward's per-channel sums, (2, C) f32 (Σdz, Σdz·x̂) in BN mode,
    (1, C) (Σdz,) in bias mode (``inv`` None, ``shift`` the bias); see
    :func:`yolojax_torch.nn.layers.epilogue_grad_sums_torch`."""
    if _device_ok(y):
        _check_y(y)
        _check_y(g, "g")
        _check_grad_args(g, y, inv, shift, m, rstd)
    return ops.epilogue_grad_sums(g, y, inv, shift, m, rstd, bool(leaky),
                                  float(alpha))


def epilogue_grad_apply_cuda(g: torch.Tensor, y: torch.Tensor, inv, shift,
                             m, rstd, mdz, mdzx, *, leaky: bool,
                             alpha: float = 0.1) -> torch.Tensor:
    """dy (..., C) bf16, row-major (see
    :func:`yolojax_torch.nn.layers.epilogue_grad_apply_torch`)."""
    if _device_ok(y):
        _check_y(y)
        _check_y(g, "g")
        _check_grad_args(g, y, inv, shift, m, rstd, mdz, mdzx)
        if inv is not None and (mdz is None or mdzx is None):
            raise ValueError("cuda_bn_train: BN mode needs mdz and mdzx")
    return ops.epilogue_grad_apply(g, y, inv, shift, m, rstd, mdz, mdzx,
                                   bool(leaky), float(alpha))


def _check_grad_args(g, y, inv, shift, m, rstd, mdz=None, mdzx=None) -> None:
    if g.shape != y.shape:
        raise ValueError(f"cuda_bn_train: g {tuple(g.shape)} and y "
                         f"{tuple(y.shape)} differ")
    bn = inv is not None
    if bn and (m is None or rstd is None):
        raise ValueError("cuda_bn_train: BN mode needs m and rstd")
    _check_vectors(y.shape[-1], y.device, inv=inv, shift=shift, m=m,
                   rstd=rstd, mdz=mdz, mdzx=mdzx)


# ---------------------------------------------------------------------------
# launches (the CUDA implementations of the custom operators)
# ---------------------------------------------------------------------------


def _vec(c: int, lds, *tensors) -> int:
    """8 channels (16 B) a thread where C, the row strides and every
    pointer allow it, else 1."""
    return 8 if c % 8 == 0 and all(ld % 8 == 0 for ld in lds) and _aligned(
        *tensors) else 1


def _raise(name: str, rc: int, err) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc} "
                           f"({err(rc).decode()})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch_sums(y: torch.Tensor, m: Optional[torch.Tensor]) -> torch.Tensor:
    """(a) on tensors :func:`bn_channel_sums_cuda` has checked."""
    y2 = _rows(y)
    rows, c = y2.shape
    out = torch.empty(c, dtype=torch.float32, device=y.device)
    if rows == 0 or c == 0:
        return out.zero_()
    ld = row_stride(y2)
    vec = _vec(c, (ld,), y2, m)
    _, _, chunk_rows, chunks = sums_geometry(rows, c, vec,
                                             _sms(y.device.index or 0))
    partial = torch.empty(chunks * c, dtype=torch.float32, device=y.device)
    run, _, _, err = _launcher()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = run(y2.data_ptr(), ld, _ptr(m), rows, c, chunk_rows, chunks, vec,
                 partial.data_ptr(), out.data_ptr(), stream)
    _raise("bn_sums_launch", rc, err)
    bn_channel_sums_cuda.launches += 1
    return out


def launch_grad_sums(g: torch.Tensor, y: torch.Tensor, inv, shift, m, rstd,
                     leaky: bool, alpha: float) -> torch.Tensor:
    """(b) on tensors :func:`epilogue_grad_sums_cuda` has checked."""
    y2, g2 = _rows(y), _rows(g)
    rows, c = y2.shape
    acc = 1 if inv is None else 2
    out = torch.empty((acc, c), dtype=torch.float32, device=y.device)
    if rows == 0 or c == 0:
        return out.zero_()
    ldy, ldg = row_stride(y2), row_stride(g2)
    vec = _vec(c, (ldy, ldg), y2, g2, inv, shift, m, rstd)
    _, _, chunk_rows, chunks = sums_geometry(rows, c, vec,
                                             _sms(y.device.index or 0))
    partial = torch.empty(acc * chunks * c, dtype=torch.float32,
                          device=y.device)
    _, run, _, err = _launcher()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = run(g2.data_ptr(), ldg, y2.data_ptr(), ldy, _ptr(inv),
                 _ptr(shift), _ptr(m), _ptr(rstd), float(alpha),
                 int(bool(leaky)), rows, c, chunk_rows, chunks, vec,
                 partial.data_ptr(), out.data_ptr(), stream)
    _raise("grad_sums_launch", rc, err)
    epilogue_grad_sums_cuda.launches += 1
    return out


def launch_grad_apply(g: torch.Tensor, y: torch.Tensor, inv, shift, m, rstd,
                      mdz, mdzx, leaky: bool, alpha: float) -> torch.Tensor:
    """(c) on tensors :func:`epilogue_grad_apply_cuda` has checked."""
    y2, g2 = _rows(y), _rows(g)
    rows, c = y2.shape
    out = torch.empty(y.shape, dtype=torch.bfloat16, device=y.device)
    if rows == 0 or c == 0:
        return out
    _, _, run, err = _launcher()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = run(g2.data_ptr(), row_stride(g2), y2.data_ptr(), row_stride(y2),
                 _ptr(inv), _ptr(shift), _ptr(m), _ptr(rstd), _ptr(mdz),
                 _ptr(mdzx), float(alpha), int(bool(leaky)), rows, c,
                 out.data_ptr(), stream)
    _raise("grad_apply_launch", rc, err)
    epilogue_grad_apply_cuda.launches += 1
    return out


bn_channel_sums_cuda.launches = 0  # kernel launches since the last reset
epilogue_grad_sums_cuda.launches = 0
epilogue_grad_apply_cuda.launches = 0
