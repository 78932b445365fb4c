"""ssm.step_ms_per_pass: the device time of the Mamba2 state steps (the
state step kernel's and the gated norm kernel's events that start inside
the kept decode regions, every Mamba2 layer's) over the kept
``decode.pass`` records, in ms (``harness/ssm_steps.py``).  None for a
program that keeps no ``ssm.step`` record."""

from bench_torch.harness.ssm_steps import step_time


def read(run):
    found = step_time(run)
    if found is None:
        return None
    return 1e3 * found.device_s / found.passes
