"""Step timing and tracing (port of ``yolojax/utils/profiling.py``).

``profile_trace`` records a ``torch.profiler`` trace (host and, on the
card, device activity) as a Chrome trace under a directory, where yolojax
records a ``jax.profiler`` trace. ``enable_debug_nans`` turns on autograd's
anomaly detection, the nearest counterpart of ``jax_debug_nans``: the
backward op that first makes a NaN raises with the forward's traceback.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace into ``<logdir>/trace.json``."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def enable_debug_nans(on: bool = True) -> None:
    torch.autograd.set_detect_anomaly(on)


class StepTimer:
    """Wall-clock per-step timing with warmup-aware running stats."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self.last = float("nan")  # nan until a step runs (0-step resumes)
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += dt
        self.last = dt

    @property
    def mean(self) -> float:
        n = self.count - self.warmup
        return self.total / n if n > 0 else float("nan")
