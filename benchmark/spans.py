"""The program's own spans (``yolojax_torch.utils.profiling.span``) in a
traced run, for the per-layer readers.

The port records a span only while a ``torch.profiler`` session runs,
which in a run is the traced window, and on ``time.time_ns()``, the clock
of ``harness.DeviceTrace``'s events. A reader keeps the spans that ended
inside the window. Every function here returns None where there is
nothing to read: no trace, a program that records no spans, spans
dropped by a full buffer, or none of the names asked for.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from benchmark.harness import Run, busy_intervals, merge


def window(run: Run) -> Optional[Tuple[int, int]]:
    t = run.outcome.trace
    return (t.t0, t.t1) if t is not None and t.t1 > t.t0 else None


def in_window(run: Run, *names: str, overlapping: bool = False
              ) -> Optional[list]:
    """The program's spans named ``names`` that ended inside the traced
    window (``overlapping``: that share any time with it), in the order
    they ended."""
    w = window(run)
    if w is None:
        return None
    from yolojax_torch.utils import profiling

    if not hasattr(profiling, "spans") or profiling.spans_dropped():
        return None
    got = [s for s in profiling.spans() if s.name in names and (
        s.t0 < w[1] and s.t1 > w[0] if overlapping
        else w[0] <= s.t1 <= w[1])]
    return got or None


def seconds(spans: Iterable) -> float:
    return sum(s.t1 - s.t0 for s in spans) / 1e9


def mean_ms(run: Run, name: str) -> Optional[float]:
    """Host milliseconds a span of ``name``."""
    got = in_window(run, name)
    return 1e3 * seconds(got) / len(got) if got else None


def per_step_ms(run: Run, name: str) -> Optional[float]:
    """Host milliseconds in spans of ``name`` a step of the window."""
    got = in_window(run, name)
    steps = run.outcome.recorder.counters.get("steps", 0)
    return 1e3 * seconds(got) / steps if got and steps else None


def per_batch_ms(run: Run, child: str) -> Optional[float]:
    """Worker milliseconds in ``child`` spans a loader batch, over the
    ``loader.batch`` spans that ended in the window and their children."""
    got = in_window(run, "loader.batch", child)
    if not got:
        return None
    batches = {s.seq for s in got if s.name == "loader.batch"}
    inside = [s for s in got if s.name == child and s.parent in batches]
    return 1e3 * seconds(inside) / len(batches) if batches else None


def overlap_s(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> float:
    """Seconds that two sets of disjoint, sorted intervals share."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total / 1e9


def idle_intervals(run: Run) -> Optional[List[Tuple[int, int]]]:
    """The window's time with no kernel running on the device: the
    complement of ``harness.busy_intervals``."""
    w = window(run)
    if w is None:
        return None
    out, at = [], w[0]
    for a, b in busy_intervals(run.outcome.trace) + [(w[1], w[1])]:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    return out


def clipped(run: Run, spans: Iterable) -> List[Tuple[int, int]]:
    """The spans' intervals within the window, merged."""
    w0, w1 = window(run)
    return merge([(max(s.t0, w0), min(s.t1, w1)) for s in spans
                  if min(s.t1, w1) > max(s.t0, w0)])
