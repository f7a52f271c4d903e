"""Share of the traced window in which no kernel ran on the device,
under the daemon's arrivals."""


def read(run):
    return run.idle_pct()
