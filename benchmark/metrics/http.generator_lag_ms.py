"""How late the open-loop sender ran: the 95th percentile of send time
minus due time over the window's requests."""


def read(run):
    return run.outcome.recorder.counters.get("lag_p95_ms")
