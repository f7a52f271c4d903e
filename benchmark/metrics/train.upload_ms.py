"""Host milliseconds a step in the program's ``train.upload`` spans
(``global_batch``'s pageable ``.to(device)`` of each array)."""

from benchmark import spans


def read(run):
    return spans.per_step_ms(run, "train.upload")
