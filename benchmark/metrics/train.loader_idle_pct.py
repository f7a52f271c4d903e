"""Share of the loader's Python workers' time in the window with no
batch being built: 1 - (time in ``loader.batch`` spans, and in the
decode and letterbox spans of batches begun before the window, where the
recorder was off) over (workers x window), each span cut to the window.
An epoch starts min(``queue.num_threads``, its batches) workers."""

from benchmark import spans

CHILDREN = ("loader.decode", "loader.letterbox")


def read(run):
    got = spans.in_window(run, "loader.batch", *CHILDREN, overlapping=True)
    if not got or not any(s.name == "loader.batch" for s in got):
        return None
    w0, w1 = spans.window(run)
    mix = run.cell.mix
    workers = min(int(run.ini("queue.num_threads", "8")),
                  mix["images"] // mix["batch"])
    work = [s for s in got if s.name == "loader.batch" or s.parent is None]
    busy = sum(b - a for t in {s.thread for s in work} for a, b in
               spans.clipped(run, [s for s in work if s.thread == t]))
    return 100.0 * (1.0 - busy / (workers * (w1 - w0)))
