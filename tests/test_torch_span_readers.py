"""The benchmark's readers of the port's spans (``benchmark/spans.py``,
``benchmark/metrics/``), each on a run made by hand: device events and
program spans whose values are worked out below, and nothing to read."""

import pytest

from benchmark import harness
from yolojax_torch.utils import profiling
from yolojax_torch.utils.profiling import Span

T0 = 1_800_000_000_000_000_000  # the window's start, unix ns
MS = 1_000_000

DETECT = "yolo2-voc-416.detect-b128"
TRAIN = "yolo2-voc-416.train-b64"
MAIN, W1, W2, W3 = 1, 11, 12, 13  # thread ids


def span(name, a, b, thread=MAIN, seq=0, parent=None, id=None, n=None):
    return Span(name, T0 + a * MS, T0 + b * MS, thread, seq, parent, id, n)


def make_run(cell, length_ms, events=(), counters=None):
    trace = harness.DeviceTrace()
    trace.t0, trace.t1 = T0, T0 + length_ms * MS
    trace.events = [(n, T0 + a * MS, T0 + b * MS) for n, a, b in events]
    rec = harness.Recorder()
    rec.counters.update(counters or {})
    out = harness.Outcome(0, 0, {}, {}, 0, rec, trace)
    return harness.Run(harness.load_cell(cell), out, None)


# two calls of infer in a window of 100 ms; a third ends after it, and one
# ended before it
DETECT_SPANS = [
    span("detect.upload", -20, -5, id=9, n=10 ** 9),
    span("detect.upload", 0, 40, id=0, n=280_000_000),
    span("detect.dispatch", 40, 45, id=0),
    span("detect.readback", 45, 55, id=0),
    span("detect.upload", 55, 95, id=1, n=280_000_000),
    span("detect.dispatch", 95, 98, id=1),
    span("detect.readback", 98, 100, id=1),
    span("detect.upload", 99, 130, id=2, n=280_000_000),
]
# kernels 42-54 and 96-99 ms; the copy leaves the device idle: idle
# 0-42, 54-96 and 99-100 (85 ms), of which 0-40 and 55-95 are in uploads
DETECT_EVENTS = [("Memcpy HtoD (Pageable -> Device)", 5, 38),
                 ("conv_kernel", 42, 50), ("nms_kernel", 49, 54),
                 ("conv_kernel", 96, 99)]

# the loader's workers in a window of 1 s: batch 10 on W1, the tail of a
# batch begun before the window on W2 (its spans have no parent) and then
# batch 20, and batch 30 on W3, which ends after the window
TRAIN_SPANS = [
    span("loader.decode", 100, 150, W1, 1, 10, (0, 0)),
    span("loader.letterbox", 150, 250, W1, 2, 10, (0, 0)),
    span("loader.decode", 250, 300, W1, 3, 10, (0, 0)),
    span("loader.letterbox", 300, 400, W1, 4, 10, (0, 0)),
    span("loader.batch", 100, 600, W1, 10, None, (0, 0), 64),
    span("loader.decode", 10, 60, W2, 5, None, (0, 0)),
    span("loader.letterbox", 60, 160, W2, 6, None, (0, 0)),
    span("loader.decode", 200, 260, W2, 21, 20, (0, 1)),
    span("loader.letterbox", 260, 380, W2, 22, 20, (0, 1)),
    span("loader.batch", 200, 900, W2, 20, None, (0, 1), 64),
    span("loader.decode", 900, 950, W3, 31, 30, (0, 2)),
    span("loader.batch", 900, 1100, W3, 30, None, (0, 2), 64),
] + [span("train.upload", 10 * k, 10 * k + 5, n=1) for k in range(8)] + [
    span("train.upload", 995, 1005, n=1),
    span("train.update", 500, 507, id=0),
    span("train.update", 700, 709, id=1),
]

CASES = [
    # 560 MB in 80 ms of upload
    ("detect.upload_gb_per_s", DETECT, 7.0),
    ("detect.dispatch_ms", DETECT, 4.0),   # (5 + 3) / 2
    ("detect.readback_ms", DETECT, 6.0),   # (10 + 2) / 2
    ("detect.idle_upload_pct", DETECT, 100.0 * 80 / 85),
    # batches 10 and 20 ended in the window: (50 + 50 + 60) / 2
    ("train.decode_ms", TRAIN, 80.0),
    ("train.letterbox_ms", TRAIN, 160.0),  # (100 + 100 + 120) / 2
    # 8 workers x 1000 ms; busy 500 (W1), 150 + 700 (W2), 100 (W3)
    ("train.loader_idle_pct", TRAIN, 100.0 * (1 - 1450 / 8000)),
    ("train.upload_ms", TRAIN, 20.0),      # 8 x 5 ms over 2 steps
    ("train.update_ms", TRAIN, 8.0),       # (7 + 9) / 2 steps
]


def run_of(cell):
    if cell == DETECT:
        return make_run(DETECT, 100, DETECT_EVENTS), DETECT_SPANS
    return make_run(TRAIN, 1000, counters={"steps": 2}), TRAIN_SPANS


@pytest.mark.parametrize("metric,cell,want", CASES,
                         ids=[c[0] for c in CASES])
def test_reader_reads_the_spans(monkeypatch, metric, cell, want):
    run, fake = run_of(cell)
    monkeypatch.setattr(profiling, "spans", lambda: list(fake))
    assert harness.load_reader(metric)(run) == pytest.approx(want)


@pytest.mark.parametrize("metric,cell,want", CASES,
                         ids=[c[0] for c in CASES])
def test_reader_without_spans_reads_nothing(monkeypatch, metric, cell,
                                            want):
    run, fake = run_of(cell)
    read = harness.load_reader(metric)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(run) is None  # a run with the recorder off
    monkeypatch.setattr(profiling, "spans", lambda: list(fake))
    monkeypatch.setattr(profiling, "spans_dropped", lambda: 1)
    assert read(run) is None  # a full buffer: the spans are not all there
    monkeypatch.setattr(profiling, "spans_dropped", lambda: 0)
    run.outcome.trace = None
    assert read(run) is None  # an untraced run
    run, _ = run_of(cell)
    monkeypatch.delattr(profiling, "spans")
    assert read(run) is None  # a program that records no spans
