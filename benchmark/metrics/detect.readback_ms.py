"""Host milliseconds a call in the program's ``detect.readback`` span of
``build_detector``'s ``infer``: waiting on the card and copying the four
outputs back."""

from benchmark import spans


def read(run):
    return spans.mean_ms(run, "detect.readback")
