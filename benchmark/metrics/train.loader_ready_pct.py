"""Share of the consumer's ``loader.get`` spans that ended in the window
and found their batch already built (``n`` 1), rather than waiting for a
worker (``n`` 0). The span wraps the wait for the next in-order batch
inside ``Loader.epoch``."""

from benchmark import spans


def read(run):
    got = spans.in_window(run, "loader.get")
    if not got:
        return None
    return 100.0 * sum(s.n == 1 for s in got) / len(got)
