"""kernels.decode_roofline: the least time the window's decode work needs
on one H100 (weight bytes of every layer and the head once a pass, the KV
cache at its valid length, at 3.35 TB/s; or its operations at 989
TFLOP/s, whichever is longer), over the device's busy time inside the
decode spans, in %.  Launches and the kernels that did the work are not
counted, so the yardstick stays whatever kernel a change puts there."""

from bench_torch.families import family_of
from bench_torch.harness.work import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def _least(model, tokens, passes, context):
    family = family_of(model)
    seconds_bytes = family.decode_bytes(model, passes, context) / PEAK_HBM_BYTES
    seconds_ops = family.decode_flops(model, tokens, context) / PEAK_BF16_FLOPS
    return max(seconds_bytes, seconds_ops)


def read(run):
    if run.trace is None:
        return None
    model, least = run.model, 0.0
    sched_tokens, sched_context = 0, 0.0
    for r in run.records:
        n = len(r.get("ids") or [])
        if not n:
            continue
        start = (r.get("prefill_lens") or [0])[-1]
        context = n * (start + n / 2.0)
        if r.get("scheduled"):
            sched_tokens += n
            sched_context += context
        elif "passes" in r:
            least += _least(model, n, r["passes"], context)
    steps = run.engine_deltas.get("steps", 0)
    if sched_tokens and steps:
        least += _least(model, sched_tokens, steps, sched_context)
    busy = run.trace.busy_in({"decode", "scheduler.decode"})
    if not least or not busy:
        return None
    return 100.0 * least / busy
