"""Host milliseconds a call in the program's ``detect.dispatch`` span of
``build_detector``'s ``infer``: enqueueing forward, decode, top-K and
NMS."""

from benchmark import spans


def read(run):
    return spans.mean_ms(run, "detect.dispatch")
