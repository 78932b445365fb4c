"""The check itself: its schema automaton, its control and its faults.

- The copied automaton takes exactly the bytes the program's does, state
  by state, for both answer schemas, and closes at the same cost.
- Each cell, rehearsed on the CPU at its tiny profile (no card: the run's
  look for a chip is skipped), reads ``correct`` true; with the float8
  control judged in the program's place it reads ``correct`` false.
- With the timed path broken underneath (the first token of every decode
  call altered where it is produced), ``correct`` comes out false.
- A run whose process holds JAX or the JAX package gives no result.
"""

import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_torch import run as bench_run  # noqa: E402
from bench_torch.harness.spec import load_cell  # noqa: E402
from bench_torch.reference import grammar  # noqa: E402

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("schema", ["inspection", "decision_support"])
def test_schema_automaton_equals_the_programs(schema):
    from vis_tpu_torch.serving.schema import get_schema_dfa

    mine, theirs = grammar.schema_dfa(schema), get_schema_dfa(schema)
    assert np.array_equal(mine.trans, theirs.trans_table)
    assert (mine.start, mine.accept) == (theirs.start_id, theirs.accept_id)
    assert np.array_equal(np.minimum(mine.close_cost, grammar.INF), theirs.close_cost)


def test_replay_follows_the_budget_rule():
    dfa = grammar.schema_dfa("decision_support")
    replay = grammar.Replay(dfa, eos_id=256, max_tokens=256, floor=224)
    doc = (b'{"repair_cost_min":1,"repair_cost_max":2,"replace_cost_estimate":3,'
           b'"repair_time_estimate":"ab","replace_lead_time":"cd",'
           b'"recommendation":"REPAIR","reasoning":"fine.')
    forced = 0
    for b in doc:
        allowed, was_forced = replay.step_allowed()
        forced += was_forced
        assert b in allowed
        replay.advance(b)
    assert forced > 100  # keys and punctuation are forced
    replay.advance(ord('"'))
    allowed, was_forced = replay.step_allowed()
    assert was_forced and allowed.tolist() == [ord("}")]
    replay.advance(ord("}"))
    assert replay.step_allowed()[0].tolist() == [256]  # only the end of sequence


@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearsal_is_correct(cell):
    result = bench_run.run_once(load_cell(cell), 2**31 + 77, 0.5, rehearse=True)
    assert result["correct"], result["check"]
    assert result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_float8_control_is_not_correct(cell):
    # The control judged in the program's place, against the cell's own
    # limit, on the same served tokens: the program reads within it.
    result = bench_run.run_once(load_cell(cell), 2**31 + 79, 0.5, control=True, rehearse=True)
    check = result["check"]
    assert not result["correct"], check
    assert check["program_widest_gap"]["value"] <= check["widest_gap"]["limit"], check
    assert check["compared"]["value"] >= check["compared"]["limit"], check


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_token_fails_the_check(cell):
    result = bench_run.run_once(load_cell(cell), 2**31 + 78, 0.5, rehearse=True, fault="token")
    assert not result["correct"], result["check"]


def test_foreign_modules_are_told_by_their_top_level_name():
    modules = {"jax": 1, "jaxlib.xla_client": 1, "flax.linen": 1, "vis_tpu": 1,
               "vis_tpu.ops.quality": 1, "vis_tpu_torch": 1, "vis_tpu_torch.ops": 1,
               "jaxtyping": 1, "flaxen": 1, "blocked": None}
    modules["jax.numpy"] = None  # blocked, not loaded
    assert bench_run.foreign_modules(modules) == [
        "flax.linen", "jax", "jaxlib.xla_client", "vis_tpu", "vis_tpu.ops.quality"]


@pytest.mark.parametrize("name", ["jax", "vis_tpu.ops"])
def test_a_run_that_holds_jax_gives_no_result(name, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    with pytest.raises(SystemExit) as stop:
        bench_run.main(["--workload", CELLS[-1], "--seed", str(2**31 + 83), "--seconds", "0.5",
                        "--rehearse"])
    assert isinstance(stop.value.code, str) and name in stop.value.code
    assert capsys.readouterr().out == ""
