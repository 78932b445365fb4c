"""scheduler.occupancy: tokens the scheduler delivered to requests over
its steps in the window, the mean number of slots doing useful work a
step."""


def read(run):
    steps = run.engine_deltas.get("steps", 0)
    tokens = sum(len(r["ids"]) for r in run.records if r.get("scheduled") and r.get("ids"))
    if not steps or not tokens:
        return None
    return tokens / steps
