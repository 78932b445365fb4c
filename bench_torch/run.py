"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's engine(s) with weights made on the card from the seed,
warms the cell's path up, then serves the cell's traffic in a closed loop
for ``--seconds``, and on until the traffic's block in flight at the
deadline is finished and counted (``block`` requests, the mix every block
repeats, so every window holds whole blocks), and prints one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics from a profiler trace of the window),
``device`` and, last, ``check``: each number the correctness check
compared, with its limit.  The same numbers end standard error.

After the window the program is freed and the plain float32 reference
(``reference/``) reads the served greedy requests (``harness/check.py``).
With ``--control`` the float8 control takes the program's place in that
comparison: ``correct`` is decided by the control's readings, against the
same limits, and the program's own readings are printed beside them.
The run refuses to start without a CUDA device, and gives no result (it
exits non-zero and names the modules) where the process holds ``jax``,
``jaxlib``, ``flax`` or the JAX package ``vis_tpu`` as the window closes
or before the result is printed.  ``--rehearse`` runs the
cell's tiny profile on the CPU instead: the whole path and the check,
with no metric and no device reading.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

GAP_LABELS = ("vision", "prefill", "decode", "scheduler.decode", "generate", "request")
# Top-level module names that no run may hold: JAX and the JAX package the
# port was made from.  ``vis_tpu_torch`` is another top-level name.
FOREIGN = ("jax", "jaxlib", "flax", "vis_tpu")


def foreign_modules(modules=None):
    """The loaded modules of ``modules`` (``sys.modules``) whose top-level
    name is one of ``FOREIGN``; a name blocked as None is not loaded."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name, module in list(modules.items())
                  if module is not None and name.split(".")[0] in FOREIGN)


def refuse_foreign_modules(when: str) -> None:
    """Stop the run, with no result, if the process holds a foreign module."""
    found = foreign_modules()
    if found:
        raise SystemExit(f"{when}, the process holds {', '.join(found)}: a run that loads "
                         f"JAX or the JAX package gives no result")


class Run:
    """What a driver and a metric reader see of one run."""

    def __init__(self, cell, model, serving, traffic, seed, device, recorder, workdir):
        self.cell, self.model, self.serving, self.traffic = cell, model, serving, traffic
        self.seed, self.device, self.recorder, self.workdir = seed, device, recorder, workdir
        self.done = []
        self.records = []
        self.timings = {}
        self.window_s = 0.0
        self.engine_deltas = {}
        self.trace = None


def _merge(base, override):
    out = dict(base)
    out.update(override or {})
    return out


def _set_environment(serving):
    os.environ.update({k: str(v) for k, v in serving.items()})
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))


def _engine_counters(engines):
    out = {"decode_s": 0.0, "decode_tokens": 0, "steps": 0}
    for e in engines:
        out["decode_s"] += e.decode_device_s_total
        out["decode_tokens"] += e.decode_tokens_total
        if e.scheduler is not None:
            out["steps"] += e.scheduler.stats["steps"]
    return out


class Trace:
    """The traced window: the union of device busy intervals, the events,
    and the benchmark's host spans, all on the Unix clock in ns."""

    def __init__(self, prof, lo, hi, spans):
        from bench_torch.harness import timeline

        self.lo, self.hi, self.spans = lo, hi, spans
        s, e, self.names = timeline.device_events(prof)
        self.ev_s, self.ev_e = s, e
        bs, be = timeline.union(s, e)
        self.busy_s, self.busy_e = timeline.clip(bs, be, lo, hi)

    def busy_seconds(self):
        from bench_torch.harness import timeline

        return timeline.total(self.busy_s, self.busy_e) / 1e9

    def busy_in(self, names):
        from bench_torch.harness import timeline

        sel = [(a, b) for n, a, b, _ in self.spans if n in names]
        if not sel:
            return 0.0
        return timeline.overlap(self.busy_s, self.busy_e, [a for a, _ in sel],
                                [b for _, b in sel]) / 1e9

    def breakdown(self):
        from bench_torch.harness import timeline

        spans = [(n, a, b) for n, a, b, _ in self.spans]
        return {"device_ops": timeline.top_ops(self.ev_s, self.ev_e, self.names),
                "idle_gaps": timeline.labelled_gaps(self.busy_s, self.busy_e, self.lo,
                                                    self.hi, spans, GAP_LABELS)}


def run_once(cell, seed, seconds, trace=False, control=False, rehearse=False, fault=None,
             t_start=None):
    """Serve one cell once; returns the result line as a dict (without
    printing).  ``t_start`` is the process start for ``setup_s``."""
    import torch

    from bench_torch.harness.check import compare
    from bench_torch.harness.record import Recorder

    t_start = T_START if t_start is None else t_start
    cfg = cell.config
    if rehearse:
        model = _merge(cfg["model"], cfg["rehearsal"]["model"])
        serving = _merge(cfg["serving"], cfg["rehearsal"].get("serving"))
        traffic = _merge(cell.traffic, cell.traffic.get("rehearsal"))
        device = torch.device("cpu")
    else:
        model, serving, traffic = cfg["model"], cfg["serving"], cell.traffic
        device = torch.device("cuda:0")
    _set_environment(serving)

    import vis_tpu_torch.serving.engine as engine_mod
    import vis_tpu_torch.serving.scheduler as scheduler_mod
    from vis_tpu_torch.utils.config import get_config
    from vis_tpu_torch.utils.logger import get_timings

    get_config(reload=True)
    recorder = Recorder()
    recorder.install(engine_mod, scheduler_mod)
    workdir = ROOT / "bench_torch" / ".work"
    run = Run(cell, model, serving, traffic, seed, device, recorder, workdir)
    driver = cell.driver().Driver(run)
    try:
        driver.setup()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        recorder.requests.clear()
        recorder.fault = fault
        get_timings(reset=True)
        before = _engine_counters(driver.engines)
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            recorder.spans_on = True
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        lo_ns = time.time_ns()
        t_w0 = time.perf_counter()
        setup_s = t_w0 - t_start
        requests = driver.requests()
        block = int(traffic.get("block", 1))
        while (not run.done or len(run.done) % block
               or time.perf_counter() - t_w0 < seconds):
            item = next(requests, None)
            if item is None:  # the plan ran out: the window ends here
                break
            t0 = time.perf_counter()
            with recorder.span("request"):
                out = driver.serve(item)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            out["t0"], out["t1"] = t0, time.perf_counter()
            run.done.append(out)
        hi_ns = time.time_ns()
        if prof is not None:
            prof.stop()
            recorder.spans_on = False
        refuse_foreign_modules("as the window closed")
        run.window_s = run.done[-1]["t1"] - t_w0
        run.records = list(recorder.requests)
        run.timings = get_timings(reset=True)
        after = _engine_counters(driver.engines)
        run.engine_deltas = {k: after[k] - before[k] for k in after}
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        if prof is not None:
            run.trace = Trace(prof, lo_ns, hi_ns, list(recorder.spans))
            del prof
        items = driver.check_items(run.done)
    finally:
        driver.release()
        recorder.uninstall()
    del driver
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    tokens = sum(d["tokens"] for d in run.done)
    if trace:
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {
            "request_s": statistics.fmean(d["t1"] - d["t0"] for d in run.done),
            "tokens_per_s": tokens / run.window_s,
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    recorder.fault = None
    readings = compare(model, items, device, control=control) if items else {
        "compared": 0, "illegal": 0, "widest_gap": float("inf"),
        "control_widest_gap": float("inf")}
    limits = dict(cell.limits, **(cell.limits.get("rehearsal", {}) if rehearse else {}))
    judged = "control_" if control else ""
    check = {
        "widest_gap": {"value": readings[f"{judged}widest_gap"], "limit": limits["widest_gap"]},
        "compared": {"value": readings["compared"], "limit": limits["min_compared"]},
    }
    if control:
        check["program_widest_gap"] = {"value": readings["widest_gap"],
                                       "limit": limits["widest_gap"]}
    correct = (check["widest_gap"]["value"] <= limits["widest_gap"]
               and readings["compared"] >= limits["min_compared"])
    result = {
        "correct": bool(correct),
        "attempted": len(run.done),
        "failed": sum(1 for d in run.done if d["failed"]),
        "metrics": metrics,
    }
    if rehearse:
        result = {"rehearsal": True, "correct": result["correct"],
                  "attempted": result["attempted"], "failed": result["failed"]}
    else:
        result["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": cell.chips, "memory_peak_bytes": int(peak),
        }
        if run.trace is not None:
            result["device"]["busy_s"] = run.trace.busy_seconds()
            result["device"]["window_s"] = (run.trace.hi - run.trace.lo) / 1e9
            result["breakdown"] = run.trace.breakdown()
    result["check"] = check
    return result


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="judge the float8 control in the program's place (for setting "
                        "limits; the program's readings are printed beside it)")
    p.add_argument("--rehearse", action="store_true",
                   help="the cell's tiny profile on the CPU: no metrics")
    return p.parse_args(argv)


def print_result(result) -> None:
    refuse_foreign_modules("before the result")
    for name, entry in result["check"].items():
        print(f"check {name} {entry['value']!r} limit {entry['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = _args(argv)
    import torch

    from bench_torch.harness.spec import load_cell

    cell = load_cell(args.workload)
    if not args.rehearse:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
    result = run_once(cell, args.seed, args.seconds, trace=bool(args.trace),
                      control=args.control, rehearse=args.rehearse)
    print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
