"""Device choice for the port's entry points.

Entry points run on the CUDA card unless the caller names another device
(the CPU tests pass ``device="cpu"``). With no device named and no card
present they raise: they never carry on quietly on the CPU.
"""

from __future__ import annotations

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
