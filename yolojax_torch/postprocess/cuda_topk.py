"""Wrapper of the CUDA exact top-K select (``csrc/topk_select.cu``).

Replaces ``torch.sort(scores, descending=True, stable=True)`` over every
score of an image, of which the post-process keeps the first K. No Pallas
kernel stands behind it: yolojax selects with ``lax.top_k``. The kernel is
bound by the bytes of one read of the scores (see the note at the top of
the source): each CTA loads a slice of a row once into shared memory,
finds the slice's K-th largest key by radix select, keeps its survivors in
index order, and a last level, one CTA a row, sorts the row's K survivors.
The levels follow from the shape alone (:func:`yolojax_torch.postprocess.
nms.topk_plan`): one launch for a row that fits one CTA (v1, v2), two for
YOLOv3's 1.82 M scores an image.

:func:`topk_select_cuda` checks its arguments and calls the custom
operator ``yolojax_torch::topk_select`` (``kernels/ops.py``): for a CUDA
tensor the operator launches the kernels through :func:`launch` and raises
on any error; for a CPU tensor it runs the plain twin
(:func:`yolojax_torch.postprocess.nms.topk_select_torch`). There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from yolojax_torch.kernels import build, ops
from yolojax_torch.postprocess.nms import topk_plan

MAX_K = 1024  # the last level's survivors in shared memory; NMS's limit too
NVCC_FLAGS = ()  # integer keys: no floating-point arithmetic to contract


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = build.load("topk_select", NVCC_FLAGS)
    fn = lib.topk_select_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
    fn.restype = ctypes.c_int
    err = lib.topk_select_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def topk_select_cuda(scores: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-K of each row. scores (N, L) f32 -> (values (N, k) f32,
    indices (N, k) int64): ``torch.sort(scores, 1, descending=True,
    stable=True)``'s first k columns, ties in ascending index order."""
    if scores.dtype != torch.float32:
        raise TypeError(f"topk_select_cuda: scores must be float32, got "
                        f"{scores.dtype}")
    if scores.dim() != 2 or scores.shape[0] < 1:
        raise ValueError(f"topk_select_cuda: want scores (N, L) with N >= 1, "
                         f"got {tuple(scores.shape)}")
    if not 1 <= k <= scores.shape[1]:
        raise ValueError(f"topk_select_cuda: k={k} outside [1, L="
                         f"{scores.shape[1]}]")
    if scores.device.type != "cpu":  # the kernel's own limits
        if k > MAX_K:
            raise ValueError(f"topk_select_cuda: k={k} > {MAX_K}")
        if scores.device.type != "cuda":
            raise ValueError(f"topk_select_cuda: scores on {scores.device}; "
                             "want a CUDA device (or the CPU for the plain "
                             "twin)")
        if not scores.is_contiguous():
            raise ValueError("topk_select_cuda: scores must be contiguous")
        if scores.shape[0] > 65535 or scores.shape[1] >= 2 ** 31:
            raise ValueError(f"topk_select_cuda: scores {tuple(scores.shape)} "
                             "exceed the grid (N <= 65535, L < 2**31)")
    return ops.topk_select(scores, int(k))


def launch(scores: torch.Tensor,
           k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernels on tensors :func:`topk_select_cuda` has checked
    (the CUDA implementation of ``yolojax_torch::topk_select``)."""
    n, length = scores.shape
    plan = topk_plan(length, k)
    dev = scores.device
    vals = torch.empty((n, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n, k), dtype=torch.int64, device=dev)
    # survivors of the levels before the last, in two alternating pairs
    words = [0, 0]
    for level, (s, _) in enumerate(plan[:-1]):
        words[level % 2] = max(words[level % 2], n * s * k)
    scratch = [(torch.empty(w, dtype=torch.int32, device=dev),
                torch.empty(w, dtype=torch.int32, device=dev))
               for w in words]
    flat_plan = (ctypes.c_int * (2 * len(plan)))(
        *[v for level in plan for v in level])
    run, err = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = run(scores.data_ptr(), n, length, k, flat_plan, len(plan),
                 scratch[0][0].data_ptr(), scratch[0][1].data_ptr(),
                 scratch[1][0].data_ptr(), scratch[1][1].data_ptr(),
                 vals.data_ptr(), idx.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"topk_select_launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    topk_select_cuda.launches += 1
    return vals, idx


topk_select_cuda.launches = 0  # launch sets (one a select) since the last reset
