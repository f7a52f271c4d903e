"""Device milliseconds a batch of the detect program's top-K select
(``postprocess/nms.py::_select_candidates`` through
``postprocess/cuda_topk.py``): every kernel whose name holds
``topk_select`` (``csrc/topk_select.cu``: one launch a batch where a row
fits one CTA, two for YOLOv3's rows). A program that selects otherwise
launches no such kernel, and reads nothing."""

FRAGMENT = "topk_select"


def read(run):
    batches = run.outcome.recorder.counters.get("batches", 0)
    seconds, launches = run.kernel_seconds(FRAGMENT)
    if not batches or not launches:
        return None
    return seconds * 1e3 / batches
