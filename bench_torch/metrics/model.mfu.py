"""model.mfu: the model operations of the window (a request's inputs, such
as a vision tower, then prefill and decode, counted from the configuration
and what was served) over the window's length times the H100's 989
TFLOP/s (bf16, dense), in %."""

from bench_torch.families import family_of
from bench_torch.harness.work import PEAK_BF16_FLOPS


def read(run):
    if not run.window_s:
        return None
    model, flops = run.model, 0.0
    family = family_of(model)
    for r in run.records:
        flops += family.input_flops(model, r)
        for n in r.get("prefill_lens") or []:
            flops += family.prefill_flops(model, n)
        n = len(r.get("ids") or [])
        start = (r.get("prefill_lens") or [0])[-1]
        flops += family.decode_flops(model, n, n * (start + n / 2.0))
    return 100.0 * flops / (run.window_s * PEAK_BF16_FLOPS)
