"""Time chip_smoke.py's int4 slice for two checkouts on one NVIDIA GPU, in turns.

    python3 tools/compare_slices.py BEFORE_DIR AFTER_DIR [--rounds 2]

Each directory is a checkout of the repository (for instance the parent
commit unpacked with ``git archive`` into a git-ignored directory, and the
working tree ``.``).  In each, a fresh process builds that checkout's
kernels and engines and runs its ``chip_smoke.phase_slice`` on the int4
profile: three ``run_inspection`` requests with the full-size Qwen2.5-VL-7B
inspector and Llama-3.1-8B explainer (random weights from chip_smoke's
seed).  The runs go BEFORE, AFTER, AFTER, BEFORE (``--rounds`` pairs), so
that both sides see the same card and the same drift.  It prints each
request's line as chip_smoke prints it, then for each side the median over
its requests of the wall, the inspector's decode span, vision_encode and
the scheduler's ms a step.  Both checkouts must have chip_smoke.py with
``phase_slice``; nothing here imports jax or the JAX package.
"""

from __future__ import annotations

import argparse
import ast
import re
import statistics
import subprocess
import sys
from pathlib import Path

RUN = """
import os, chip_smoke as cs
for k, v in cs.PROFILE.items():
    os.environ[k] = v
cs.WORK.mkdir(parents=True, exist_ok=True)
cs.phase_card()
cs.phase_build()
cs.phase_slice({label!r}, cs.PROFILE, "ABCD")
"""
REQUEST = re.compile(r"request \d+: wall ([0-9.]+) s, spans (\{.*?\}), .*?\(([0-9.]+) ms a step\)")


def run_slice(directory: Path, label: str) -> list:
    """One process in ``directory``; returns (wall, spans, ms a step) a request."""
    proc = subprocess.run([sys.executable, "-c", RUN.format(label=label)], cwd=directory,
                          capture_output=True, text=True, timeout=1200)
    lines = [line for line in proc.stdout.splitlines() if "request" in line or "launches" in line]
    for line in lines:
        print(line[:480], flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"{label} in {directory} failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
    found = [REQUEST.search(line) for line in lines]
    return [(float(m[1]), ast.literal_eval(m[2]), float(m[3])) for m in found if m]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("before", type=Path)
    parser.add_argument("after", type=Path)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    results = {"before": [], "after": []}
    order = []
    for i in range(args.rounds):
        order += [("before", "after")[i % 2], ("after", "before")[i % 2]]
    for side in order:
        results[side] += run_slice(getattr(args, side), side)
    for side, rows in results.items():
        med = {name: statistics.median(fn(r) for r in rows) for name, fn in (
            ("wall s", lambda r: r[0]), ("inspector decode s", lambda r: r[1]["engine.decode"]),
            ("vision_encode s", lambda r: r[1]["engine.vision_encode"]),
            ("scheduler ms a step", lambda r: r[2]))}
        print(f"{side} ({getattr(args, side)}), median of {len(rows)} requests: "
              + ", ".join(f"{k} {v:.4f}" for k, v in med.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
