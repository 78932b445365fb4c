"""device.idle_share: the share of the traced window in which no
operation ran on the device (the union of the profiler's device
intervals, each counted once), in %."""


def read(run):
    if run.trace is None:
        return None
    window = (run.trace.hi - run.trace.lo) / 1e9
    if window <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_seconds() / window)
