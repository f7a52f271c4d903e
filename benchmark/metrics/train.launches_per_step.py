"""Kernel launches on the device a train step, from the trace: a count
that repeats exactly from step to step."""

from benchmark.harness import is_copy


def read(run):
    steps = run.outcome.recorder.counters.get("steps", 0)
    kernels = sum(1 for n, _, _ in run.events if not is_copy(n))
    return kernels / steps if steps and kernels else None
