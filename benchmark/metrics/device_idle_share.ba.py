"""device_idle_share.ba: percent of the traced solve's wall time in
which no operation ran on the device (1 - union of the device intervals /
the traced window)."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0 or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
