"""Step timing and tracing (port of ``yolojax/utils/profiling.py``).

``profile_trace`` records a ``torch.profiler`` trace (host and, on the
card, device activity) as a Chrome trace under a directory, where yolojax
records a ``jax.profiler`` trace. ``enable_debug_nans`` turns on autograd's
anomaly detection, the nearest counterpart of ``jax_debug_nans``: the
backward op that first makes a NaN raises with the forward's traceback.

``span`` marks a stage of the host's work (an upload, a dispatch, a
decode) while a ``torch.profiler`` session runs, and only then: each span
is kept in memory on ``time.time_ns()``, the clock the profiler puts its
device events on, and also enters ``record_function``, so a Chrome trace
shows it beside the kernels. ``spans()`` reads what was kept. With no
profiler running a span checks one flag and records nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Any, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


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


class Span(NamedTuple):
    """One recorded span: ``t0``/``t1`` in ``time.time_ns()``, the thread
    it ran on, its serial number and its parent's on that thread (None at
    the top), the id of the batch or call it serves, and a count (bytes
    or images)."""

    name: str
    t0: int
    t1: int
    thread: int
    seq: int
    parent: Optional[int]
    id: Any
    n: Optional[int]


SPAN_CAPACITY = 1 << 20  # spans kept; later ones are counted as dropped

_spans: List[Span] = []
_dropped = 0
_lock = threading.Lock()
_serial = itertools.count()
_local = threading.local()
_OFF = contextlib.nullcontext()


class _Recording:
    __slots__ = ("name", "id", "n", "seq", "parent", "t0", "_rf")

    def __init__(self, name: str, id: Any, n: Optional[int]):
        self.name, self.id, self.n = name, id, n

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.seq = next(_serial)
        stack.append(self.seq)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        t1 = time.time_ns()
        self._rf.__exit__(*exc)
        _local.stack.pop()
        s = Span(self.name, self.t0, t1, threading.get_ident(), self.seq,
                 self.parent, self.id, self.n)
        with _lock:
            if len(_spans) < SPAN_CAPACITY:
                _spans.append(s)
            else:
                _dropped += 1
        return False


def span(name: str, id: Any = None, n: Optional[int] = None):
    """A context that records the stage ``name`` of the call or batch
    ``id`` (``n``: its bytes or images) while a ``torch.profiler`` session
    runs in this process, and does nothing otherwise. It adds no
    synchronisation, copy or kernel."""
    # the profiler's own process-wide flag: the C++ profiler state is
    # thread-local, and loader threads record too
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, id, n)


def spans() -> List[Span]:
    """The spans recorded so far in this process, in the order they
    ended."""
    with _lock:
        return list(_spans)


def spans_dropped() -> int:
    """Spans not kept because the buffer was full."""
    return _dropped


def clear_spans() -> None:
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0
