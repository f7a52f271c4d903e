"""Wrapper of the CUDA fused-stem kernel (``csrc/stem_fused.cu``).

Replaces ``yolojax/nn/pallas_stem.py::stem_forward_pallas``: BN-folded
conv0 (3x3, 3 -> 32) + bias + leaky 0.1 + 2x2/2 max-pool in one pass, f32
NHWC images in, bf16 NHWC pooled map out. The kernel is bound by bytes (see the note at the
top of the source): its products run on the tensor cores and its input
arrives through an asynchronous ring, so the arithmetic stays under the
memory time. It sums in another order than the plain version and is held
to it within :func:`yolojax_torch.nn.stem.stem_tolerance`.

:func:`stem_fused_cuda` checks its arguments and calls the custom
operator ``yolojax_torch::stem_fused`` (``kernels/ops.py``): for a CUDA
tensor the operator launches the kernel through :func:`launch` and raises
on what it does not take; for a CPU tensor it runs the plain version
(:func:`yolojax_torch.nn.stem.stem_fused_torch`). There is no fallback
from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from yolojax_torch.kernels import build, ops
from yolojax_torch.nn.stem import stem_mma_operand, unpack_stem_kernel

CO = 32  # the kernel's output channels (Darknet-19's and the tiny nets' conv0)
NVCC_FLAGS = ()  # the sum runs on the tensor cores: -fmad changes nothing


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = build.load("stem_fused", NVCC_FLAGS)
    fn = lib.stem_fused_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.stem_fused_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def stem_fused_cuda(x: torch.Tensor, wp: torch.Tensor, b: torch.Tensor, *,
                    wfrag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused stem. x (N, H, W, 3) f32 NHWC contiguous, H and W even; wp
    (3, 3, 12, 4*32) the packed kernel; b (32,) -> (N, H/2, W/2, 32) bf16
    NHWC. ``wfrag`` (16, 32) int32 is the kernel's B operand
    (:func:`yolojax_torch.nn.stem.stem_mma_operand`) when the caller has it
    (:class:`yolojax_torch.nn.layers.StemLayer` keeps it), else it is made
    from ``wp``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stem_fused_cuda: x on {x.device}; want a CUDA "
                         "device (or the CPU for the plain version)")
    # the operator takes conv0's kernel in the layout of x's device
    w = wp if x.device.type == "cpu" else _kernel_operand(x, wp, b, wfrag)
    return ops.stem_fused(x, w, b)


def _kernel_operand(x: torch.Tensor, wp: torch.Tensor, b: torch.Tensor,
                    wfrag: Optional[torch.Tensor]) -> torch.Tensor:
    """Check the arguments against what the kernel takes and return its B
    operand ``wfrag``."""
    if x.dtype != torch.float32:
        raise ValueError(f"stem_fused_cuda: x must be float32, got {x.dtype}")
    if x.dim() != 4 or x.shape[3] != 3:
        raise ValueError(f"stem_fused_cuda: want x (N, H, W, 3), got "
                         f"{tuple(x.shape)}")
    n, h, w, _ = x.shape
    if h % 2 or w % 2 or n < 1:
        raise ValueError(f"stem_fused_cuda: want N >= 1 and even H and W, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("stem_fused_cuda: x must be contiguous NHWC")
    if tuple(wp.shape) != (3, 3, 12, 4 * CO) or tuple(b.shape) != (CO,):
        raise ValueError(f"stem_fused_cuda: want wp (3, 3, 12, {4 * CO}) and "
                         f"b ({CO},), got {tuple(wp.shape)} and "
                         f"{tuple(b.shape)}")
    if wfrag is None:
        wfrag = stem_mma_operand(unpack_stem_kernel(wp.detach().float()))
    if tuple(wfrag.shape) != (16, 32) or wfrag.dtype != torch.int32:
        raise ValueError(f"stem_fused_cuda: want wfrag (16, 32) int32, got "
                         f"{tuple(wfrag.shape)} {wfrag.dtype}")
    for name, t in (("wfrag", wfrag), ("b", b)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"stem_fused_cuda: {name} must be contiguous on "
                             f"{x.device}, got {t.device}")
    if b.dtype != torch.float32:
        raise ValueError(f"stem_fused_cuda: b must be float32, got {b.dtype}")
    return wfrag


def launch(x: torch.Tensor, wfrag: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on tensors :func:`stem_fused_cuda` has checked
    (the CUDA implementation of ``yolojax_torch::stem_fused``)."""
    n, h, w, _ = x.shape
    out = torch.empty((n, h // 2, w // 2, CO), dtype=torch.bfloat16,
                      device=x.device)
    run, err = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = run(x.data_ptr(), wfrag.data_ptr(), b.data_ptr(), out.data_ptr(),
                 n, h, w, stream)
    if rc != 0:
        raise RuntimeError(f"stem_fused_launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    stem_fused_cuda.launches += 1
    return out


stem_fused_cuda.launches = 0  # kernel launches since the last reset
