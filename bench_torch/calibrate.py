"""Readings to set a cell's check limit from: the program's widest gap and
the float8 control's, over many seeds in one process.

    python3 bench_torch/calibrate.py --workload <cell> --seeds 2147483701,2147483702 --seconds 20

Each seed is one full run of the cell (its own weights, its own traffic,
a window of ``--seconds``) with the float8 control judged in the
program's place and the program's own reading beside it (``correct``
there is the control's, and must read false).  One
JSON line a seed, then a summary: the largest program reading, the
smallest control reading, and their ratio.  Not part of a benchmark run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args()

    import torch

    from bench_torch import run as bench_run
    from bench_torch.harness.spec import load_cell

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    program, control = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        result = bench_run.run_once(cell, seed, args.seconds, control=True,
                                    t_start=time.perf_counter())
        check = result["check"]
        program.append(check["program_widest_gap"]["value"])
        control.append(check["widest_gap"]["value"])
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"], "failed": result["failed"],
                          "metrics": result["metrics"], "check": check}), flush=True)
    lower, upper = max(program), min(control)
    print(json.dumps({"workload": args.workload, "program_max": lower, "control_min": upper,
                      "ratio": upper / lower if lower else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
