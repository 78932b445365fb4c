"""The hybrid decoder of ``vis_tpu_torch`` (Nemotron-H: Mamba2 mixers,
attention without positional encoding, squared-ReLU MLPs, in a published
order) against the plain reference of ``bench_torch/families/nemotron_h.py``.

The program runs at the configuration's rehearsal size on the CPU in
float32, on the reference's own seeded weights dequantized (runner cases
``nemotron_h*`` in torch_port_runner.py): the two then differ only in the
order of float32 sums (the chunked scan against the token-by-token
recurrence, batched products, blocked attention), so logits are held to
``TOL`` of their largest magnitude and greedy tokens must be equal.

- bucketed prefill, then decode through ``_eos_loop`` over a dense cache
  and through the paged scheduler (3 slots, admissions between chunks, a
  slot reused by a new request): logits at every decoded row and greedy
  tokens;
- the same prompt in two buckets: the same state, ring, K/V and logits
  (pad positions step nothing);
- the chunked scan against the recurrence at lengths off the chunk, and
  one Mamba2 mixer three ways (prefill, a token at a time, a prefill then
  tokens) against the reference's mixer;
- lookahead windows, chunk extension and chat on a hybrid config raise
  ``NotImplementedError`` naming it;
- the family's bytes a decode pass at the published configuration, against
  a hand count; the family works where the program cannot be imported, and
  only its ``program_config`` imports the program;
- the two ``ssm.step`` readers on a hand-built timeline: the step's two
  kernels by name, starting inside the kept decode regions, wherever the
  host's ``ssm.step`` spans lie;
- the benchmark cell rehearsed on the CPU (int4 and int8 weights, bf16
  activations) reads ``correct`` true, and its float8 control false.

On a card (``python -m pytest -m cuda tests/test_torch_nemotron_h.py
--noconftest``; it skips elsewhere) the state step kernel of
``csrc/ssm_step.cu`` is held to its plain version: y and the state within
2^-14 of their largest magnitude (only the readout's sum order and the exp
and log1p roundings differ), the conv ring bit for bit, two runs the same
bits; the wrapper refuses a state size the kernel does not take.  The fused
norms of ``csrc/norms.cu`` are held to theirs the same way.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from torch_port import run_port

REPO = Path(__file__).resolve().parents[1]
CELL = "explain.nemotron_h_47b.bundle"
# Float32 against float32 on the same weights: only the order of sums
# differs (measured below 2e-6 of max|ref|), so 1e-4 of it is room without
# letting a wrong term through (a dropped state carry or a pad step moves
# logits by 1e-2 and more).
TOL = 1e-4
SPEC = {
    "seed": 1901,
    "dense": {"prompt": 45, "bucket": 64, "cache": 128, "steps": 40},
    "buckets": {"prompt": 45, "buckets": [64, 128]},
    "scan_lengths": [45, 100],
    "split": 37,
    "paged": {"max_len": 256, "page": 16, "pool": 512, "chunk": 8,
              "prompts": {"A": 30, "B": 50, "C": 20, "D": 41},
              "budgets": {"A": 10, "B": 40, "C": 24, "D": 20},
              "schedule": ["A", "B", "decode", "C", "decode", "D", "decode"]},
}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_port("nemotron_h", {"spec": np.array(json.dumps(SPEC))},
                    tmp_path_factory.mktemp("nemotron_h"))


def _close(got, want, what):
    err = float(np.abs(got - want).max())
    assert err <= TOL * float(np.abs(want).max()), (what, err, float(np.abs(want).max()))


def test_prefill_then_dense_decode_equals_the_reference(port):
    got, ref = port["dense/got"], port["dense/ref"]
    assert got.shape == ref.shape == (SPEC["dense"]["steps"], 512)
    _close(got, ref, "dense logits")
    np.testing.assert_array_equal(port["dense/tokens"], ref.argmax(axis=1))


@pytest.mark.parametrize("name", list(SPEC["paged"]["prompts"]))
def test_paged_scheduler_decode_equals_the_reference(port, name):
    prefix = f"paged/{name}"
    assert str(port[f"{prefix}/error"]) == ""
    got, ref = port[f"{prefix}/got"], port[f"{prefix}/ref"]
    assert len(got) == len(port[f"{prefix}/tokens"]) > 0
    _close(got, ref, f"paged logits of {name}")
    np.testing.assert_array_equal(port[f"{prefix}/tokens"], ref.argmax(axis=1))


def test_a_freed_slot_takes_the_next_request(port):
    # A (budget 10) finished in the second chunk; D, admitted after it,
    # took its slot and still matched the reference above: nothing of A's
    # state carried over.
    assert len(port["paged/A/tokens"]) == SPEC["paged"]["budgets"]["A"]
    assert int(port["paged/D/slot"]) == int(port["paged/A/slot"])
    assert len({int(port[f"paged/{n}/slot"]) for n in "ABC"}) == 3


@pytest.mark.parametrize("key", ["logits", "ssm", "conv", "k"])
def test_two_buckets_give_the_same_state(port, key):
    small, large = SPEC["buckets"]["buckets"]
    _close(port[f"bucket{small}/{key}"], port[f"bucket{large}/{key}"], key)


@pytest.mark.parametrize("n", SPEC["scan_lengths"])
def test_chunked_scan_equals_the_recurrence(port, n):
    _close(port[f"scan{n}/y"], port[f"scan{n}/y_ref"], "scan outputs")
    _close(port[f"scan{n}/state"], port[f"scan{n}/state_ref"], "final state")


@pytest.mark.parametrize("way", ["prefill", "steps", "split"])
@pytest.mark.parametrize("n", SPEC["scan_lengths"])
def test_mixer_equals_the_references(port, n, way):
    _close(port[f"mixer{n}/{way}"], port[f"mixer{n}/ref"], f"mixer by {way}")


@pytest.fixture(scope="module")
def refusals(tmp_path_factory):
    return run_port("nemotron_h_refusals", {"seed": np.array(5)},
                    tmp_path_factory.mktemp("nemotron_h_refusals"))


@pytest.mark.parametrize("attempt", ["chat", "schema", "extend", "lookahead"])
def test_lookahead_and_chat_refuse_a_hybrid_config(refusals, attempt):
    message = str(refusals[attempt])
    assert message.startswith("NotImplementedError"), message
    assert "hybrid stack of 7 blocks (3 Mamba2, 1 attention, 3 MLP)" in message, message


def test_free_form_requests_still_decode(refusals):
    assert isinstance(str(refusals["greedy"]), str)


@pytest.fixture(scope="module")
def alone(tmp_path_factory):
    return run_port("nemotron_h_alone", {}, tmp_path_factory.mktemp("nemotron_h_alone"))


def test_weight_bytes_per_pass_at_the_published_config(alone):
    h, inter, vocab = 8192, 30720, 131072
    in_proj = 16384 + (16384 + 2 * 8 * 256) + 256          # z | xBC | dt = 37,120 rows
    mamba = (in_proj * h // 2 + in_proj * 8               # int4 in_proj, two f32 scales a row
             + h * 16384 // 2 + h * 8                     # int4 out_proj
             + h * 2 + 16384 * 2                          # bf16 block norm, gated norm
             + 20480 * 4 * 2 + 20480 * 2                  # bf16 conv weight [20480, 4], bias
             + 3 * 256 * 4)                               # f32 A_log, dt_bias, D
    mlp = 2 * (h * inter // 2) + (inter + h) * 8 + h * 2  # int4 up, down; scales; norm
    qkv = (64 + 2 * 8) * 128                              # 10,240 rows
    attention = qkv * h // 2 + qkv * 8 + h * 8192 // 2 + h * 8 + h * 2
    head = vocab * h + vocab * 4                          # int8 head, f32 row scales
    total = 45 * mamba + 48 * mlp + 5 * attention + head + h * 2  # and the final norm
    assert json.loads(str(alone["counts"])) == {"mamba": 45, "attention": 5, "mlp": 48}
    assert float(alone["weight_bytes"]) == total
    # 22.3 GB of int4 projections and the 1.07 GB head: a pass reads no
    # embedding table, only its rows.
    assert 23.3e9 < total < 23.6e9
    # One sequence's state step in one layer: the f32 state both ways, the
    # ring's three taps read and the new entry written, xBC and dt in, z in
    # and y out (bf16).
    state = 2 * 256 * 64 * 256 * 4 + 4 * 20480 * 2 + (20480 + 256) * 2 + 2 * 16384 * 2
    assert float(alone["state_bytes"]) == state
    assert float(alone["kv_bytes"]) == 5 * 2 * 8 * 128 * 2
    assert float(alone["decode_bytes"]) == 10 * (total + 45 * state) + 1000 * 20480


def test_published_config_and_model_group_agree():
    # The file gives the source's config at its top level, as published, and
    # the numbers the benchmark runs under ``model``: one set of numbers, so
    # the two must not drift apart.
    cfg = json.loads((REPO / "bench_torch" / "configs" / "nemotron_h_47b.json").read_text())
    model = cfg["model"]
    published = [k for k in cfg if k in model]
    assert [k for k in model if k not in published] == [
        "head_quantization", "layer_quantization", "torch_dtype"]
    assert {k: cfg[k] for k in published} == {k: model[k] for k in published}
    assert cfg["reduced"] == ["eos_token_id"] and model["eos_token_id"] == 256
    pattern = cfg["hybrid_override_pattern"]
    assert len(pattern) == cfg["num_hidden_layers"] == 98
    assert (pattern.count("M"), pattern.count("-"), pattern.count("*")) == (45, 48, 5)


def test_the_family_needs_no_program(alone):
    assert np.isfinite(alone["logits"]).all() and alone["logits"].shape == (1, 512)
    assert float(alone["decode_flops"]) > 0 and float(alone["prefill_flops"]) > 0
    assert str(alone["program_config"]).startswith("ImportError"), str(alone["program_config"])


def test_only_program_config_imports_the_program():
    tree = ast.parse((REPO / "bench_torch" / "families" / "nemotron_h.py").read_text())

    def port_imports(node):
        found = []
        for inner in ast.walk(node):
            if isinstance(inner, ast.Import):
                found += [a.name for a in inner.names]
            elif isinstance(inner, ast.ImportFrom) and inner.module:
                found.append(inner.module)
        return [m for m in found if m.split(".")[0] in ("vis_tpu_torch", "vis_tpu", "jax")]

    top = [node for node in tree.body if not isinstance(node, ast.FunctionDef)]
    assert not [m for node in top for m in port_imports(node)]
    importers = {fn.name for fn in tree.body
                 if isinstance(fn, ast.FunctionDef) and port_imports(fn)}
    assert importers == {"program_config"}


# name: (rows, heads, head dim, state size, groups, each row's cursor): the
# bundle cell's shape, a small one, odd rows, cursors that start a ring and
# wrap it.
SSM_CARD_CASES = {
    "cell": (3, 256, 64, 256, 8, [0, 1, 1234]),
    "small": (1, 16, 32, 128, 2, [2]),
    "rows5": (5, 64, 64, 256, 8, [0, 3, 4, 7, 1001]),
    "one-group": (2, 8, 32, 128, 1, [5, 6]),
}


# The fused norms: (rows, hidden, in_proj row width, d_inner, groups), the
# gate a strided view of an in_proj row as on the main path.
NORM_CARD_CASES = [(3, 8192, 37120, 16384, 8), (37, 128, 520, 256, 2), (1, 64, 200, 128, 1)]


@pytest.fixture(scope="module")
def card(tmp_path_factory):
    out = run_port("ssm_step_card", {"cases": np.array(json.dumps(SSM_CARD_CASES)),
                                     "norm_cases": np.array(json.dumps(NORM_CARD_CASES))},
                   tmp_path_factory.mktemp("ssm_step_card"))
    if str(out["skip"]):
        pytest.skip(str(out["skip"]))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SSM_CARD_CASES))
def test_state_step_kernel_matches_plain(card, name):
    err, scale, ring_equal, repeatable = card[name].tolist()
    assert err <= 2.0 ** -14 * scale, (err, scale)
    assert ring_equal == 1.0 and repeatable == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", NORM_CARD_CASES, ids=lambda c: f"{c[0]}x{c[1]}")
def test_fused_norm_kernels_match_plain(card, case):
    # The sum of squares is a tree on the card: an output may move by one
    # bf16 step, 2^-7 of the largest; the residual add rounds as torch's.
    norm_err, norm_scale, x_equal, gated_err, gated_scale = card[
        f"norms/{case[0]}x{case[1]}"].tolist()
    assert x_equal == 1.0
    assert norm_err <= 2.0 ** -7 * norm_scale and gated_err <= 2.0 ** -7 * gated_scale


@pytest.mark.cuda
def test_state_step_kernel_refuses_other_state_sizes(card):
    assert "N in" in str(card["refused"]), str(card["refused"])


# A hand-built window [0, 1 ms] on the card's path: thread 2 decodes two
# chunks, each a scheduler.chunk around its scheduler.decode.  The first,
# [0, 500] us, has two passes with an ``ssm.step`` span each; the second,
# [600, 900], is overlapped by thread 3's prefill and left out.
US = 1000


def _rec(name, rid, parent, thread, start_us, end_us):
    return {"name": name, "id": rid, "parent": parent, "thread": thread,
            "start_ns": start_us * US, "end_ns": end_us * US}


SSM_RECORDS = [
    _rec("scheduler.chunk", 1, None, 2, 0, 500),
    _rec("scheduler.decode", 2, 1, 2, 10, 500),
    _rec("decode.pass", 3, 2, 2, 10, 250),
    _rec("ssm.step", 4, 3, 2, 20, 30),
    _rec("decode.pass", 5, 2, 2, 250, 490),
    _rec("ssm.step", 6, 5, 2, 260, 270),
    _rec("scheduler.chunk", 7, None, 2, 600, 900),
    _rec("scheduler.decode", 8, 7, 2, 600, 900),
    _rec("decode.pass", 9, 8, 2, 600, 900),
    _rec("ssm.step", 10, 9, 2, 610, 620),
    _rec("engine.prefill", 11, None, 3, 650, 700),
]
# Counted: the step kernel at 25 us (35 us long) and the gated norm at 280,
# which the device started after its span had ended.  Not counted: a
# projection inside the first span, the step kernel in the left-out chunk,
# and one past the window.
SSM_EVENTS = [("void ssm_step_kernel<256>(bf16 const*, int)", 25, 60),
              ("q4_stacked_mma_kernel<4, (Form)0>", 22, 29),
              ("gated_group_norm_kernel(bf16 const*)", 280, 300),
              ("void ssm_step_kernel<256>(bf16 const*, int)", 700, 720),
              ("void ssm_step_kernel<256>(bf16 const*, int)", 1000, 1010)]
STEP_DEVICE_S = 55e-6


def _ssm_run(**extra):
    ev_s = np.array([a * US for _, a, _ in SSM_EVENTS], np.int64)
    ev_e = np.array([b * US for _, _, b in SSM_EVENTS], np.int64)
    return SimpleNamespace(trace=SimpleNamespace(lo=0, hi=1000 * US, ev_s=ev_s, ev_e=ev_e,
                                                 names=[n for n, _, _ in SSM_EVENTS]),
                           **extra)


def _ssm_reader(metric):
    from bench_torch.harness.spec import BENCH_DIR, load_module

    return load_module(BENCH_DIR / "metrics" / f"{metric}.py", f"bench_metric_{metric}")


def test_step_ms_per_pass_reads_the_step_kernels_by_name(monkeypatch):
    import vis_tpu_torch.utils.logger as program_logger

    reader = _ssm_reader("ssm.step_ms_per_pass")
    run = _ssm_run()
    monkeypatch.setattr(program_logger, "get_trace", lambda: [dict(r) for r in SSM_RECORDS])
    assert reader.read(run) == pytest.approx(1e3 * STEP_DEVICE_S / 2, rel=1e-12)
    # A program that keeps no ssm.step record (no hybrid decoder) is silent.
    monkeypatch.setattr(program_logger, "get_trace", lambda: [
        dict(r) for r in SSM_RECORDS if r["name"] != "ssm.step"])
    assert reader.read(run) is None
    assert reader.read(SimpleNamespace(trace=None)) is None


def test_step_roofline_reads_the_served_tokens_over_the_step_kernels(monkeypatch):
    import vis_tpu_torch.utils.logger as program_logger

    reader = _ssm_reader("kernels.ssm_step_roofline")
    state = 2 * 256 * 64 * 256 * 4 + 4 * 20480 * 2 + (20480 + 256) * 2 + 2 * 16384 * 2
    family = SimpleNamespace(counts=lambda model: {"mamba": 45},
                             state_update_bytes=lambda model: state)
    monkeypatch.setattr(reader, "family_of", lambda model: family)
    monkeypatch.setattr(program_logger, "get_trace", lambda: [dict(r) for r in SSM_RECORDS])
    # Six tokens served over three passes, two of them kept: four count.
    records = [{"scheduled": True, "ids": [1, 2, 3, 4]}, {"scheduled": True, "ids": [5, 6]},
               {"scheduled": False, "ids": [7, 8, 9]}]
    run = _ssm_run(model={}, records=records)
    least = 4 * 45 * state / 3.35e12
    assert reader.read(run) == pytest.approx(100 * least / STEP_DEVICE_S, rel=1e-12)
    monkeypatch.setattr(reader, "family_of", lambda model: SimpleNamespace())
    assert reader.read(run) is None


def _rehearse(seed, *extra):
    proc = subprocess.run(
        [sys.executable, str(REPO / "bench_torch" / "run.py"), "--workload", CELL, "--seed",
         str(seed), "--seconds", "0.5", "--rehearse", *extra],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cell_rehearsal_is_correct():
    result = _rehearse(2**31 + 1901)
    assert result["correct"] and result["failed"] == 0, result


def test_cell_rehearsal_control_is_not_correct():
    result = _rehearse(2**31 + 1903, "--control")
    check = result["check"]
    assert not result["correct"], check
    assert check["program_widest_gap"]["value"] <= check["widest_gap"]["limit"], check
