"""decode.device_ops_per_pass: the profiler's device events (kernels,
copies, sets) that start inside the program's decode regions (see
``harness/passes.py``), over the ``decode.pass`` records (weight passes)
inside them: the launches a pass costs."""

import numpy as np

from bench_torch.harness import timeline
from bench_torch.harness.passes import decode_records


def read(run):
    found = decode_records(run)
    if found is None:
        return None
    us, ue = timeline.union(*found.region_bounds())
    starts = np.sort(run.trace.ev_s)
    inside = (np.searchsorted(starts, ue, side="left")
              - np.searchsorted(starts, us, side="left")).sum()
    return float(inside) / len(found.passes)
