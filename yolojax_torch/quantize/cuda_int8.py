"""Wrapper of the CUDA int8 requant epilogue (``csrc/int8_requant.cu``).

Replaces the epilogue XLA fuses after each int8 product of
``yolojax/quantize/ptq.py::apply_int8`` (``ptq.py:363-368``, and with the
phase max of the fused int8 stem ``ptq.py:319-325``): int32 sums in, int8
codes out, in one pass. The kernel is bound by bytes (see the note at the
top of the source).

For a CUDA tensor :func:`int8_requant_cuda` launches the kernel and raises
on what it does not take; for a CPU tensor it runs the plain version
(:func:`yolojax_torch.quantize.int8_ops.int8_requant_torch`). There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yolojax_torch.kernels import build
from yolojax_torch.quantize.int8_ops import int8_requant_torch

PHASES = (1, 4)  # a plain epilogue, or the int8 stem's max over 4 phases
# every step is a round-to-nearest intrinsic: nothing left to contract
NVCC_FLAGS = ()


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = build.load("int8_requant", NVCC_FLAGS)
    fn = lib.int8_requant_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.int8_requant_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def int8_requant_cuda(acc: torch.Tensor, m: torch.Tensor, b: torch.Tensor,
                      r: float, qmax: int, leaky: bool,
                      phases: int = 1) -> torch.Tensor:
    """acc (M, phases*C) int32, row-major with any row stride >= phases*C
    (a column slice of a wider product is taken as it is); m, b
    (phases*C,) f32 contiguous; ``r`` = f32(1) / f32(scale) -> (M, C) int8
    codes (see :func:`int8_requant_torch` for the recipe)."""
    if acc.device.type == "cpu":
        return int8_requant_torch(acc, m, b, r, qmax, leaky, phases)
    if acc.device.type != "cuda":
        raise ValueError(f"int8_requant_cuda: acc on {acc.device}; want a "
                         "CUDA device (or the CPU for the plain version)")
    if phases not in PHASES:
        raise ValueError(f"int8_requant_cuda: phases must be one of {PHASES}, "
                         f"got {phases}")
    if acc.dtype != torch.int32 or acc.dim() != 2:
        raise ValueError(f"int8_requant_cuda: want acc (M, C) int32, got "
                         f"{tuple(acc.shape)} {acc.dtype}")
    rows, cols = acc.shape
    if cols % phases:
        raise ValueError(f"int8_requant_cuda: {cols} columns do not split "
                         f"into {phases} phases")
    if acc.stride(1) != 1 or acc.stride(0) < cols:
        raise ValueError(f"int8_requant_cuda: acc must be row-major, got "
                         f"strides {acc.stride()}")
    for name, t in (("m", m), ("b", b)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (cols,)
                or t.device != acc.device or not t.is_contiguous()):
            raise ValueError(f"int8_requant_cuda: want {name} ({cols},) "
                             f"float32 contiguous on {acc.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not 0 < qmax <= 127:
        raise ValueError(f"int8_requant_cuda: qmax {qmax} outside (0, 127]")
    channels = cols // phases
    out = torch.empty((rows, channels), dtype=torch.int8, device=acc.device)
    if rows == 0 or channels == 0:
        return out
    launch, err = _launcher()
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        rc = launch(acc.data_ptr(), acc.stride(0), m.data_ptr(), b.data_ptr(),
                    out.data_ptr(), rows, channels, phases, float(r),
                    int(qmax), int(bool(leaky)), stream)
    if rc != 0:
        raise RuntimeError(f"int8_requant_launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    int8_requant_cuda.launches += 1
    return out


int8_requant_cuda.launches = 0  # kernel launches since the last reset
