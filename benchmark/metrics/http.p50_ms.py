"""The median latency of the window's requests, timed as the tail is:
from when each was due to when its reply arrived."""


def read(run):
    return run.outcome.recorder.counters.get("p50_ms")
