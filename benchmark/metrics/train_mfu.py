"""The whole train step's share of the bf16 peak: images stepped per
second of the traced window times 3 x the forward's FLOPs at the train
dim (forward, and the two halves of the backward)."""

from benchmark import counts


def read(run):
    rate = run.outcome.e2e["train_img_per_s"]
    flops = 3 * counts.flops_per_image(run.cell.config, run.cell.mix["dim"])
    return 100.0 * rate * flops / counts.PEAK_BF16
