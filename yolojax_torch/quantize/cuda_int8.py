"""Wrapper of the CUDA int8 requant epilogue (``csrc/int8_requant.cu``).

Replaces the epilogue XLA fuses after each int8 product of
``yolojax/quantize/ptq.py::apply_int8`` (``ptq.py:363-368``, and with the
phase max of the fused int8 stem ``ptq.py:319-325``): int32 sums in, int8
codes out, in one pass. The kernel is bound by bytes (see the note at the
top of the source).

:func:`int8_requant_cuda` checks its arguments and calls the custom
operator ``yolojax_torch::int8_requant`` (``kernels/ops.py``): for a CUDA
tensor the operator launches the kernel through :func:`launch` and raises
on what it does not take; for a CPU tensor it runs the plain version
(:func:`yolojax_torch.quantize.int8_ops.int8_requant_torch`). There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yolojax_torch.kernels import build, ops

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
    if acc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_requant_cuda: acc on {acc.device}; want a "
                         "CUDA device (or the CPU for the plain version)")
    if acc.device.type == "cuda":  # the kernel's own limits
        _check(acc, m, b, qmax, phases)
    return ops.int8_requant(acc, m, b, float(r), int(qmax), bool(leaky),
                            int(phases))


def _check(acc: torch.Tensor, m: torch.Tensor, b: torch.Tensor, qmax: int,
           phases: int) -> None:
    """Raise on what the kernel does not take."""
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


def launch(acc: torch.Tensor, m: torch.Tensor, b: torch.Tensor, r: float,
           qmax: int, leaky: bool, phases: int) -> torch.Tensor:
    """Launch the kernel on tensors :func:`int8_requant_cuda` has checked
    (the CUDA implementation of ``yolojax_torch::int8_requant``)."""
    rows, cols = acc.shape
    channels = cols // phases
    out = torch.empty((rows, channels), dtype=torch.int8, device=acc.device)
    if rows == 0 or channels == 0:
        return out
    run, err = _launcher()
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        rc = run(acc.data_ptr(), acc.stride(0), m.data_ptr(), b.data_ptr(),
                 out.data_ptr(), rows, channels, phases, float(r),
                 int(qmax), int(bool(leaky)), stream)
    if rc != 0:
        raise RuntimeError(f"int8_requant_launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    int8_requant_cuda.launches += 1
    return out


int8_requant_cuda.launches = 0  # kernel launches since the last reset
