"""The whole detect program's share of the card's peak over the time the
device was busy: the window's images times the FLOPs an image, over the
peak and the union of the kernels' intervals (copies left out). The bf16
program counts every conv at the bf16 peak; the int8 program its trunk at
the int8 peak and its bf16 head at the bf16 peak (``counts.py``)."""

from benchmark import counts


def read(run):
    images = run.outcome.recorder.counters.get("images", 0)
    if run.summary is None or not run.summary.busy_s or not images:
        return None
    cfg, dim = run.cell.config, run.cell.config["input"]
    if run.ini("detect.use_int8") == "1":
        least = counts.int8_seconds_per_image(cfg, dim)
    else:
        least = counts.flops_per_image(cfg, dim) / counts.PEAK_BF16
    return 100.0 * images * least / run.summary.busy_s
