"""scheduler.step_ms: the program's ``scheduler.decode`` span (a chunk,
ended by its token read-back) summed over the window, per scheduler step,
in ms."""


def read(run):
    steps = run.engine_deltas.get("steps", 0)
    spans = run.timings.get("scheduler.decode", [])
    if not steps or not spans:
        return None
    return 1000.0 * sum(spans) / steps
