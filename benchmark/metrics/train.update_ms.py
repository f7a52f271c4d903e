"""Host milliseconds a step in the program's ``train.update`` span: the
optimizer's update and the in-place adds to the parameters, enqueued."""

from benchmark import spans


def read(run):
    return spans.per_step_ms(run, "train.update")
