"""The rate of ``build_detector``'s upload as the host sees it: bytes
moved to the card over the host's time in the program's
``detect.upload`` spans (the pageable ``.to(device)`` of the canvases),
in GB/s (1e9 B)."""

from benchmark import spans


def read(run):
    got = spans.in_window(run, "detect.upload")
    if not got or not spans.seconds(got):
        return None
    return sum(s.n or 0 for s in got) / spans.seconds(got) / 1e9
