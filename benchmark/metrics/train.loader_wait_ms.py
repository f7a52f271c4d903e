"""Milliseconds a step waits on ``next()`` of the loader's epoch
iterator (a harness span around each call), over the window's steps."""


def read(run):
    steps = run.outcome.recorder.counters.get("steps", 0)
    if not steps:
        return None
    return 1e3 * run.outcome.recorder.total_s("loader.next") / steps
