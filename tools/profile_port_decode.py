"""Profile the PyTorch/CUDA port's decode on one NVIDIA GPU.

    python3 tools/profile_port_decode.py [--role inspector|explainer]
        [--out chiprun_out/profile_port_decode.txt]

Builds the kernels and chip_smoke.py's engines (random weights, its seed
and serving profile: the Qwen2.5-VL-7B int4 inspector and the Llama-3.1-8B
explainer on the port, the auditor mocked; for ``--role inspector`` the
explainer mocked too) and sends assets/sample.jpg through run_inspection
once to warm up.  Then, for ``--role inspector``,
run_inspection twice (one timed request, one under torch.profiler); for
``--role explainer``, the explainer's report bundle on that request's
findings twice (timed, profiled), through the paged scheduler.  It prints:

- for each run, wall time, the spans, decode tokens and lookahead windows
  (inspector) or scheduler steps (explainer);
- for the profiled run, device self time and the busy share (device time
  over the profiled wall and over the timed run's wall);
- the host's cudaLaunchKernel and cudaStreamSynchronize calls;
- device time per kernel, largest first.

The full key_averages table goes to --out.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (blocks jax, sets the repo on sys.path)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--role", choices=("inspector", "explainer"), default="inspector")
    ap.add_argument("--out", default="chiprun_out/profile_port_decode.txt")
    args = ap.parse_args()

    for key, value in chip_smoke.PROFILE.items():
        os.environ[key] = value
    if args.role == "inspector":
        os.environ["EXPLAINER_PROVIDER"] = "mock"
    chip_smoke.WORK.mkdir(parents=True, exist_ok=True)
    chip_smoke.phase_card()
    chip_smoke.phase_build()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vis_tpu.agents import get_explainer, get_inspector
    from vis_tpu.orchestration.graph import run_inspection
    from vis_tpu.schemas.models import VLMAnalysisResult
    from vis_tpu.utils.logger import get_timings
    from vis_tpu_torch import agents as port_agents
    from vis_tpu_torch.ops import quantized as qz

    port_agents.install("cuda:0", seed=chip_smoke.SEED)
    engine = get_inspector().backend.engine
    state = {}

    def request(label: str) -> float:
        get_timings(reset=True)
        qz.q4_matmul.launches = 0
        start = time.perf_counter()
        state.update(run_inspection(str(chip_smoke.SAMPLE), criticality="high",
                                    domain="general", user_notes="profile"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        if state["inspector_result"]["analysis_failed"]:
            raise AssertionError(f"{label}: {state['inspector_result']['failure_reason']}")
        spans = {k: round(sum(v), 4) for k, v in get_timings().items()
                 if k.startswith("engine.")}
        print(f"[{label}] wall {wall:.3f} s, spans {spans}, decode tokens "
              f"{engine.last_decode_tokens}, windows {qz.q4_matmul.launches - 1}")
        return wall

    def bundle(label: str) -> float:
        result = VLMAnalysisResult(**state["inspector_result"])
        auditor = VLMAnalysisResult(**state["auditor_result"])
        scheduler = get_explainer().backend.engine.scheduler
        get_timings(reset=True)
        steps = scheduler.stats["steps"]
        start = time.perf_counter()
        get_explainer().generate_report_bundle(result, auditor, state["consensus"],
                                               state["safety_verdict"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        steps = scheduler.stats["steps"] - steps
        spans = {k: round(sum(v), 4) for k, v in get_timings().items()}
        print(f"[{label}] bundle wall {wall:.3f} s, spans {spans}, scheduler steps {steps} "
              f"({1e3 * wall / max(steps, 1):.2f} ms a step over the wall)")
        return wall

    run = bundle if args.role == "explainer" else request
    request("warm-up")
    timed = run("timed")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run("profiled")
    averages = prof.key_averages()
    device_us = sum(_device_us(e) for e in averages)
    print(f"[profiled] device self time {device_us / 1e6:.3f} s, busy share "
          f"{device_us / 1e6 / wall:.3f} of the profiled wall, "
          f"{device_us / 1e6 / timed:.3f} of the timed wall")
    for name in ("cudaLaunchKernel", "cudaStreamSynchronize"):
        hits = [e for e in averages if e.key == name]
        calls = sum(e.count for e in hits)
        cpu_s = sum(e.cpu_time_total for e in hits) / 1e6
        print(f"[profiled] {name}: {calls} calls, {cpu_s:.3f} s CPU")
    kernels = sorted((e for e in averages if _device_us(e) > 0), key=_device_us, reverse=True)
    for e in kernels[:15]:
        us = _device_us(e)
        print(f"[profiled] {us / 1e3:10.1f} ms {100 * us / device_us:5.1f}% "
              f"{e.count:7d} calls {us / e.count:9.1f} us  {e.key[:90]}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    sort_key = "self_device_time_total" if hasattr(kernels[0], "self_device_time_total") \
        else "self_cuda_time_total"
    out.write_text(averages.table(sort_by=sort_key, row_limit=60))
    print(f"[profiled] table -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
