"""Worker milliseconds a loader batch in the program's
``loader.letterbox`` spans (``letterbox_host`` on the CPU), over the
``loader.batch`` spans that ended in the window."""

from benchmark import spans


def read(run):
    return spans.per_batch_ms(run, "loader.letterbox")
