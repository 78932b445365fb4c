"""decode.idle_ms_per_pass: the time inside the union of the program's
decode regions (see ``harness/passes.py``) in which no operation ran on the
device, over the ``decode.pass`` records (weight passes) inside them, in
ms."""

from bench_torch.harness import timeline
from bench_torch.harness.passes import decode_records


def read(run):
    found = decode_records(run)
    if found is None:
        return None
    us, ue = timeline.union(*found.region_bounds())
    busy = timeline.overlap(run.trace.busy_s, run.trace.busy_e, us, ue)
    return (timeline.total(us, ue) - busy) / 1e6 / len(found.passes)
