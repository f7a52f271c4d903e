"""The port's spans and the harness's device trace share a clock: on the
card, a span around a kernel's launch and a synchronisation holds that
kernel's interval in a ``harness.DeviceTrace``. A span adds no device
event of its own to that trace."""

import pytest

from benchmark import harness

# the profiler maps the card's clock onto the host's afresh in each
# session: most sessions agree to 20 us, but some put every device event
# up to 0.26 ms early (5 of 75 sessions on an H100 read 36-261 us)
SLACK_NS = 500_000


@pytest.mark.card
def test_a_span_holds_its_kernel_on_the_device_clock(card):
    import torch

    from yolojax_torch.utils import profiling

    x = torch.randn(1 << 24, device=card)
    x.mul_(1.0)  # the kernel built and loaded before the trace
    torch.cuda.synchronize()
    profiling.clear_spans()
    trace = harness.DeviceTrace()
    trace.start()
    x.mul_(1.0)  # one kernel in the trace before the spans
    torch.cuda.synchronize()
    for k in range(8):
        with profiling.span("probe", k):
            x.mul_(1.0)
            torch.cuda.synchronize()
    trace.stop()
    got = [s for s in profiling.spans() if s.name == "probe"]
    profiling.clear_spans()
    kernels = sorted((a, b) for n, a, b in trace.events
                     if not harness.is_copy(n))
    assert len(got) == 8 and len(kernels) == 9, trace.events
    for s, (a, b) in zip(got, kernels[1:]):
        assert s.t0 - SLACK_NS <= a and b <= s.t1 + SLACK_NS, (
            a - s.t0, s.t1 - b)
