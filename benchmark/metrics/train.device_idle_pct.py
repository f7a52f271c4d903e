"""Share of the traced window in which no kernel ran on the device,
over the training loop."""


def read(run):
    return run.idle_pct()
