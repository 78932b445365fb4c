"""model.mfu: the model operations of the window (tower, prefill and
decode, counted from the configuration and what was served) over the
window's length times the H100's 989 TFLOP/s (bf16, dense), in %."""

from bench_torch.harness import work


def read(run):
    if not run.window_s:
        return None
    model, flops = run.model, 0.0
    vc = model.get("vision_config")
    for r in run.records:
        if vc is not None and r.get("grid"):
            flops += work.tower_flops(vc, *r["grid"])
        for n in r.get("prefill_lens") or []:
            flops += work.prefill_flops(model, n)
        n = len(r.get("ids") or [])
        start = (r.get("prefill_lens") or [0])[-1]
        flops += work.decode_flops(model, n, n * (start + n / 2.0))
    return 100.0 * flops / (run.window_s * work.PEAK_BF16_FLOPS)
