"""The daemon batcher's own fill (``/stats``: requests over dispatched
batch slots), over the window: images / (batches x batch)."""


def read(run):
    c = run.outcome.recorder.counters
    if not c.get("batches"):
        return None
    return 100.0 * c["images"] / (c["batches"] * c["batch"])
