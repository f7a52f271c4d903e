"""Share of the device's idle time in the window (no kernel running:
the complement of ``harness.busy_intervals``) that lies inside the
program's ``detect.upload`` spans, on the clock they share."""

from benchmark import spans


def read(run):
    got = spans.in_window(run, "detect.upload")
    idle = spans.idle_intervals(run)
    if not got or not idle:
        return None
    return 100.0 * spans.overlap_s(idle, spans.clipped(run, got)) / (
        sum(b - a for a, b in idle) / 1e9)
