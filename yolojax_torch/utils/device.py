"""Device choice for the port's entry points.

Entry points run on the CUDA card unless the caller names another device
(the CPU tests pass ``device="cpu"``). With no device named and no card
present they raise: they never carry on quietly on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


@contextlib.contextmanager
def full_f32():
    """Convs and matrix products in true f32 inside (TF32 off: cuDNN runs f32
    convs in TF32 by default), the previous settings restored on exit. The
    flags are process-wide."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
