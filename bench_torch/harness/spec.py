"""What a run is: the cell of ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell check sits in a file of its own, found by name:

- ``configs/<config>.json`` (the path is the configuration's ``file``):
  the model's sizes under ``model``, the serving settings under
  ``serving`` (environment of the program's config), a tiny profile for
  rehearsals under ``rehearsal``;
- ``families/<model_type>.py``, by the ``model_type`` of the
  configuration's ``model``: its architecture (seeded weights, the port's
  config, the plain reference, the work arithmetic);
- ``traffic/<mix>.json``: the mix's parameters and the ``driver`` that
  serves them (``drivers/<driver>.py``);
- ``metrics/<metric>.py``: ``read(run) -> float | None``;
- ``checks/<cell>.json``: the limit of each number the check compares.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str):
    """The module in ``path``, put in ``sys.modules`` under ``name`` first, as
    an import would, so that its dataclasses can resolve their annotations."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    limits: Dict[str, Any]

    def driver(self):
        name = self.traffic["driver"]
        return load_module(BENCH_DIR / "drivers" / f"{name}.py", f"bench_driver_{name}")

    def metric_reader(self, name: str):
        return load_module(BENCH_DIR / "metrics" / f"{name}.py", f"bench_metric_{name}")


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(benchmark_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload named {name!r} in {benchmark_path.name}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    from bench_torch.families import family_of

    family_of(config["model"])  # a model_type without a family file stops here
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((BENCH_DIR / "checks" / f"{name}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        limits=limits,
    )


__all__ = ["BENCH_DIR", "ROOT", "Cell", "load_cell", "load_module"]
