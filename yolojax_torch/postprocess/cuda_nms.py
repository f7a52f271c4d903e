"""Wrapper of the CUDA greedy-NMS kernel (``csrc/nms_greedy.cu``).

Replaces ``yolojax/postprocess/pallas_nms.py::nms_greedy_pallas``. The
kernel is latency-bound, not bound by bytes or FLOPs. It runs in two
phases: a build over the whole card writes each image's lower-triangle
"IoU > thr" bits into an (N, K, ceil(K/64)) uint64 scratch, and a sweep, one
warp an image, resolves the greedy chain 64 boxes at a time in registers
(see the note at the top of the source).

For a CUDA tensor :func:`nms_greedy_cuda` launches the kernel and raises on
any error; for a CPU tensor it runs the plain sweep
(:func:`yolojax_torch.postprocess.nms.nms_greedy_torch`). There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from yolojax_torch.kernels import build
from yolojax_torch.postprocess.nms import nms_greedy_torch

MAX_K = 1024  # the kernel's bit matrix and sweep handle any K up to this
# no FMA contraction: the IoU must round as the plain version does
NVCC_FLAGS = ("-fmad=false",)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = build.load("nms_greedy", NVCC_FLAGS)
    fn = lib.nms_greedy_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.nms_greedy_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def nms_greedy_cuda(boxes: torch.Tensor, valid: torch.Tensor,
                    iou_thresh: float) -> torch.Tensor:
    """Batched greedy NMS. boxes (N, K, 4) f32 score-sorted, class-offset
    corner boxes; valid (N, K) bool or uint8 -> keep (N, K) bool."""
    if boxes.device.type == "cpu" and valid.device.type == "cpu":
        return nms_greedy_torch(boxes, valid, iou_thresh)
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(f"nms_greedy_cuda: boxes on {boxes.device}, valid "
                         f"on {valid.device}; both must be on one CUDA device")
    if boxes.dtype != torch.float32:
        raise TypeError(f"nms_greedy_cuda: boxes must be float32, got "
                        f"{boxes.dtype}")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"nms_greedy_cuda: valid must be bool or uint8, got "
                        f"{valid.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 or valid.shape != boxes.shape[:2]:
        raise ValueError(f"nms_greedy_cuda: want boxes (N, K, 4) and valid "
                         f"(N, K), got {tuple(boxes.shape)} and "
                         f"{tuple(valid.shape)}")
    n, k = valid.shape
    if k > MAX_K:
        raise ValueError(f"nms_greedy_cuda: K={k} > {MAX_K}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_greedy_cuda: boxes and valid must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("nms_greedy_cuda: boxes must be 16-byte aligned")
    keep = torch.empty((n, k), dtype=torch.bool, device=boxes.device)
    if n == 0 or k == 0:
        return keep
    # the build's overlap bits, read by the sweep
    bits = torch.empty((n, k, -(-k // 64)), dtype=torch.int64,
                       device=boxes.device)
    launch, err = _launcher()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        rc = launch(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
                    bits.data_ptr(), n, k, float(iou_thresh), stream)
    if rc != 0:
        raise RuntimeError(f"nms_greedy_launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    nms_greedy_cuda.launches += 1
    return keep


nms_greedy_cuda.launches = 0  # kernel launches since the last reset
