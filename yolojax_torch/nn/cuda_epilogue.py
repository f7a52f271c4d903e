"""Wrapper of the CUDA conv epilogue (``csrc/conv_epilogue.cu``).

Replaces the epilogue XLA fuses after each bf16 conv and dense product of
``yolojax/nn/layers.py::apply_network`` (``layers.py:395-420``, dense
``:431-440``): the bf16 product in, f32 bias (or BN affine) + leaky, bf16
out, in one pass. The kernel is bound by bytes (see the note at the top of
the source). :func:`conv_epilogue_residual_cuda` is the same pass with a
residual shortcut's operand added after the cast, a kernel of its own
(``conv_epilogue_residual_kernel``) with its own launch count.

:func:`conv_epilogue_cuda` checks its arguments and calls the custom
operator ``yolojax_torch::conv_epilogue`` (``kernels/ops.py``): for a CUDA
tensor the operator launches the kernel through :func:`launch` and raises
on what it does not take; for a CPU tensor it runs the plain version
(:func:`yolojax_torch.nn.layers.conv_epilogue_torch`). There is no fallback
from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from yolojax_torch.kernels import build, ops

# every step is a round-to-nearest intrinsic: nothing left to contract
NVCC_FLAGS = ()


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = build.load("conv_epilogue", NVCC_FLAGS)
    fn = lib.conv_epilogue_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    res = lib.conv_epilogue_residual_launch
    res.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                    ctypes.c_int, ctypes.c_void_p]
    res.restype = ctypes.c_int
    err = lib.conv_epilogue_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, res, err


def conv_epilogue_cuda(y: torch.Tensor, b: torch.Tensor,
                       scale: Optional[torch.Tensor] = None, *, leaky: bool,
                       alpha: float = 0.1) -> torch.Tensor:
    """y (..., C) bf16, rows of C channels with any row stride >= C (a
    column slice is taken as it is); b and ``scale`` (C,) f32 contiguous
    -> (..., C) bf16, row-major (see :func:`conv_epilogue_torch`)."""
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_epilogue_cuda: y on {y.device}; want a CUDA "
                         "device (or the CPU for the plain version)")
    # the kernel's own limits, on real tensors: under torch.export a conv's
    # traced output may carry other strides than cuDNN gives it at run
    # time, and the exported op's launch checks the real layout itself
    if y.device.type == "cuda" and not torch.compiler.is_compiling():
        _check(y, b, scale)
    return ops.conv_epilogue(y, b, scale, bool(leaky), float(alpha))


def conv_epilogue_residual_cuda(y: torch.Tensor, b: torch.Tensor,
                                scale: Optional[torch.Tensor],
                                r: torch.Tensor, *, leaky: bool,
                                alpha: float = 0.1) -> torch.Tensor:
    """:func:`conv_epilogue_cuda` plus ``r`` (y's shape, bf16, row-major),
    the residual a shortcut adds after the cast: bf16(f32(z) + f32(r)),
    bit-equal to ``z + r`` in bf16 (see :func:`conv_epilogue_torch`)."""
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_epilogue_residual_cuda: y on {y.device}; "
                         "want a CUDA device (or the CPU for the plain "
                         "version)")
    if y.device.type == "cuda" and not torch.compiler.is_compiling():
        _check(y, b, scale)
        if (r.dtype != torch.bfloat16 or r.shape != y.shape
                or r.device != y.device or not r.is_contiguous()):
            raise ValueError(f"conv_epilogue_residual_cuda: want r "
                             f"{tuple(y.shape)} bfloat16 row-major on "
                             f"{y.device}, got {tuple(r.shape)} {r.dtype} "
                             f"on {r.device}")
    return ops.conv_epilogue(y, b, scale, bool(leaky), float(alpha), r)


def _rows(y: torch.Tensor) -> torch.Tensor:
    """``y`` as (rows, C) without a copy, or raise: the kernel reads rows of
    C contiguous channels at one row stride."""
    c = y.shape[-1]
    rows = math.prod(y.shape[:-1])
    try:
        y2 = y.view(rows, c)
    except RuntimeError:
        y2 = None
    if y2 is None or (rows > 1 and y2.stride(0) < c) or (
            c > 1 and y2.stride(1) != 1):
        raise ValueError(f"conv_epilogue_cuda: y must be rows of contiguous "
                         f"channels at one row stride, got shape "
                         f"{tuple(y.shape)} strides {y.stride()}")
    return y2


def row_stride(y2: torch.Tensor) -> int:
    """The row stride the kernel reads (rows, C) ``y2`` at (a single row's
    stride is free: C)."""
    return y2.stride(0) if y2.shape[0] > 1 else y2.shape[1]


def _check(y: torch.Tensor, b: torch.Tensor,
           scale: Optional[torch.Tensor]) -> None:
    """Raise on what the kernel does not take."""
    if y.dtype != torch.bfloat16 or y.dim() < 2:
        raise ValueError(f"conv_epilogue_cuda: want y (..., C) bfloat16, got "
                         f"{tuple(y.shape)} {y.dtype}")
    _rows(y)
    c = y.shape[-1]
    vectors = (("b", b),) if scale is None else (("b", b), ("scale", scale))
    for name, t in vectors:
        if (t.dtype != torch.float32 or tuple(t.shape) != (c,)
                or t.device != y.device or not t.is_contiguous()):
            raise ValueError(f"conv_epilogue_cuda: want {name} ({c},) float32 "
                             f"contiguous on {y.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def launch(y: torch.Tensor, b: torch.Tensor, scale: Optional[torch.Tensor],
           leaky: bool, alpha: float,
           r: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel (with ``r``: the residual kernel) on tensors
    :func:`conv_epilogue_cuda` or :func:`conv_epilogue_residual_cuda` has
    checked (the CUDA implementation of ``yolojax_torch::conv_epilogue``)."""
    y2 = _rows(y)
    rows, c = y2.shape
    out = torch.empty(y.shape, dtype=torch.bfloat16, device=y.device)
    if rows == 0 or c == 0:
        return out
    run, run_residual, err = _launcher()
    scale_ptr = None if scale is None else scale.data_ptr()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        if r is None:
            rc = run(y2.data_ptr(), row_stride(y2), b.data_ptr(), scale_ptr,
                     out.data_ptr(), rows, c, float(alpha), int(bool(leaky)),
                     stream)
        else:
            rc = run_residual(y2.data_ptr(), row_stride(y2), b.data_ptr(),
                              scale_ptr, r.data_ptr(), out.data_ptr(), rows,
                              c, float(alpha), int(bool(leaky)), stream)
    if rc != 0:
        what = "conv_epilogue_launch" if r is None else (
            "conv_epilogue_residual_launch")
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    if r is None:
        conv_epilogue_cuda.launches += 1
    else:
        conv_epilogue_residual_cuda.launches += 1
    return out


conv_epilogue_cuda.launches = 0  # kernel launches since the last reset
conv_epilogue_residual_cuda.launches = 0
