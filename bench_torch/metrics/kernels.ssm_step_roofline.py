"""kernels.ssm_step_roofline: the least time of the Mamba2 state steps the
window's decode needed, over the device time they took, in %.

Least time: every token the scheduler served steps every Mamba2 layer once
(``state_update_bytes`` of the model's family: the f32 state read and
written, the conv tail, x, B, C, dt and z in, y out), at 3.35 TB/s; the
tokens counted are the served ones in the share of passes kept
(``harness/ssm_steps.py``: passes that another thread's prefill overlaps
are left out of both sides).  Device time: the state step kernel's and
the gated norm kernel's events that start inside the kept decode regions.
None for a program that keeps no ``ssm.step`` record or a family with no
state."""

from bench_torch.families import family_of
from bench_torch.harness.ssm_steps import step_time
from bench_torch.harness.work import PEAK_HBM_BYTES


def read(run):
    family = family_of(run.model)
    if not hasattr(family, "state_update_bytes"):
        return None
    found = step_time(run)
    if found is None or not found.device_s:
        return None
    tokens = sum(len(r.get("ids") or []) for r in run.records if r.get("scheduled"))
    kept = tokens * found.passes / found.all_passes
    least = kept * family.counts(run.model)["mamba"] * family.state_update_bytes(run.model) \
        / PEAK_HBM_BYTES
    return 100.0 * least / found.device_s
