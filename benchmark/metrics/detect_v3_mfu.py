"""The YOLOv3 detect program's share of the card's bf16 peak over the time
the device was busy: the window's images times the FLOPs an image
(``counts_v3.py``: Darknet's 140.69 GFLOP at 608), over the peak and the
union of the kernels' intervals (copies left out)."""

from benchmark import counts_v3


def read(run):
    images = run.outcome.recorder.counters.get("images", 0)
    if run.summary is None or not run.summary.busy_s or not images:
        return None
    cfg = run.cell.config
    least = counts_v3.flops_per_image(cfg, cfg["input"]) / counts_v3.PEAK_BF16
    return 100.0 * images * least / run.summary.busy_s
