"""The device time of a traced window's Mamba2 state steps, read by the
``kernels.ssm_step_roofline`` and ``ssm.step_ms_per_pass`` metrics.

A hybrid decoder's decode pass holds one untimed ``ssm.step`` span per
Mamba2 layer (``vis_tpu_torch/models/common/layers.py`` ``mamba2_step``):
the state step kernel and the grouped gated norm, not the projections.
The spans do not sync, so which device events start inside one depends on
how far the device lags the host; they are not used to time the step.
Taken here instead: the profiler's events named by the step's two kernels
(``KERNELS``) that start inside the decode regions ``harness/passes.py``
keeps (regions end in a sync; a region that another thread's prefill
overlaps is left out, with its passes).  A program that keeps no
``ssm.step`` record gives None.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from bench_torch.harness import timeline
from bench_torch.harness.passes import decode_records

SPAN = "ssm.step"
KERNELS = ("ssm_step_kernel", "gated_group_norm_kernel")


class StepTime:
    """``device_s``: the device time of the step's kernels starting inside
    the kept decode regions; ``passes``: the kept ``decode.pass`` records;
    ``all_passes``: every ``decode.pass`` of the window's decode regions,
    kept or left out."""

    def __init__(self, device_s: float, passes: int, all_passes: int):
        self.device_s, self.passes, self.all_passes = device_s, passes, all_passes


def step_time(run) -> Optional[StepTime]:
    found = decode_records(run)
    if found is None:
        return None
    from vis_tpu_torch.utils.logger import get_trace

    pass_ids = {r["id"] for r in found.passes}
    if not any(r["name"] == SPAN and r["parent"] in pass_ids for r in get_trace()):
        return None
    mine = np.array([any(k in name for k in KERNELS) for name in run.trace.names], bool)
    starts, ends = run.trace.ev_s[mine], run.trace.ev_e[mine]
    us, ue = timeline.union(*found.region_bounds())
    region = np.searchsorted(us, starts, side="right") - 1  # the last region begun
    inside = (region >= 0) & (starts < ue[np.maximum(region, 0)])
    device_ns = int((ends[inside] - starts[inside]).sum())
    return StepTime(device_ns / 1e9, len(found.passes),
                    len(found.passes) + found.passes_left_out)


__all__ = ["KERNELS", "SPAN", "StepTime", "step_time"]
