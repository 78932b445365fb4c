"""engine.prefill_ms: the program's ``engine.vision_encode`` and
``engine.prefill`` spans (both end in a device synchronise) summed over
the window, per request of the cell, in ms."""


def read(run):
    spans = run.timings.get("engine.vision_encode", []) + run.timings.get("engine.prefill", [])
    if not spans or not run.done:
        return None
    return 1000.0 * sum(spans) / len(run.done)
