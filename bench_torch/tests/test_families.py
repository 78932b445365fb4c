"""Each configuration's architecture comes from its family file,
``families/<model_type>.py``, and the harness reads the same numbers as
it did when the architecture was written into the harness itself.

The pins (``family_pins.json``, ``family_logits.npz``) were computed on
the CPU with the commit before the family files, through the harness's
own functions of that commit (``harness/weights.py``'s plans and
``make_weights``, ``harness/check.py``'s sequence with
``reference/models.py``'s logits, ``harness/work.py`` and the two metric
readers), at the inputs below:

- weights: SHA-256 of every leaf (dtype, shape, bytes) of
  ``make_weights(<rehearsal model>, seed=7, cpu)``;
- full-size plans: each plan's leaves (path, shape, kind, gain) as JSON,
  its length, its first and last leaves and its SHA-256; not materialised;
- logits: the float32 reference at rows ``ROWS`` of one 300-token item
  (``item_of``; Qwen's starts with a 112x168 photo) at the rehearsal
  profile, seed 7, on one CPU thread (with more, the reduction order of
  some products follows the thread count: a few 1e-6 apart);
- work: the counts at the full-size configurations, and the tower of a
  640x480 photo at its served grid;
- readers: ``model.mfu`` and ``kernels.decode_roofline`` over a synthetic
  run (``synthetic_run``).

Beside the pins, the check (``compare``, with each family's ``sequence``
and ``logits``), the weights and the work counts are run in a process that
cannot import the program: the reference takes nothing from it.

Run: ``python -m pytest bench_torch/tests/test_families.py -q`` (CPU,
about 20 s).
"""

import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_torch import families  # noqa: E402
from bench_torch.families import family_of  # noqa: E402
from bench_torch.harness import spec  # noqa: E402
from bench_torch.harness.check import compare  # noqa: E402
from bench_torch.harness.weights import make_weights, plan_of  # noqa: E402
from bench_torch.reference.primitives import EXACT, exact_matmuls  # noqa: E402

HERE = Path(__file__).resolve().parent
CONFIGS = ["mistral_7b_v0_3", "qwen2_5_vl_7b"]
PINS = json.loads((HERE / "family_pins.json").read_text())
ROWS = [3 + 18 * k for k in range(16)]


def load(name):
    """(full-size model, rehearsal model) of a configuration file."""
    cfg = json.loads((ROOT / "bench_torch" / "configs" / f"{name}.json").read_text())
    return cfg["model"], dict(cfg["model"], **cfg["rehearsal"]["model"])


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from leaves(tree[k], path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def digest(t):
    t = t.contiguous()
    h = hashlib.sha256(f"{t.dtype} {tuple(t.shape)}".encode())
    h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def item_of(name):
    """A check item of 300 tokens: 200 context and 100 served ids, or for
    the VLM a 112x168 photo (26 tokens), 174 context and 100 served."""
    g = torch.Generator().manual_seed(1)
    if name == "qwen2_5_vl_7b":
        ctx = torch.randint(0, 256, (174,), generator=g).tolist()
        served = torch.randint(0, 256, (100,), generator=g).tolist()
        return {"seed": 7, "photo": {"seed": 7, "index": 0, "height": 112, "width": 168},
                "pieces": [{"ids": ctx}, {"ids": served, "served": True}]}
    ctx = torch.randint(0, 256, (200,), generator=g).tolist()
    served = torch.randint(0, 256, (100,), generator=g).tolist()
    return {"seed": 7, "pieces": [{"ids": ctx}, {"ids": served, "served": True}]}


def synthetic_run(model, grid=None):
    """A window of one unbatched request (with its image's grid, if any)
    and two scheduled ones."""
    records = [{"ids": list(range(448)), "prefill_lens": [3000], "passes": 350},
               {"ids": list(range(200)), "prefill_lens": [120, 500], "scheduled": True},
               {"ids": list(range(96)), "prefill_lens": [800], "scheduled": True}]
    if grid is not None:
        records[0]["grid"] = list(grid)
    return SimpleNamespace(model=model, records=records, window_s=10.0,
                           engine_deltas={"steps": 300},
                           trace=SimpleNamespace(busy_in=lambda names: 2.5))


@pytest.mark.parametrize("name", CONFIGS)
def test_rehearsal_weights_are_the_parents_bytes(name):
    _, tiny = load(name)
    got = {path: digest(t) for path, t in leaves(make_weights(tiny, 7, "cpu"))}
    assert got == PINS["weights"][name]


@pytest.mark.parametrize("name", CONFIGS)
def test_full_size_plan_is_the_parents(name):
    full, _ = load(name)
    plan = plan_of(full)
    listing = {"bytes": [[list(p), list(s)] for p, s in plan.byte_leaves],
               "floats": [[list(p), list(s), k, g] for p, s, k, g in plan.float_leaves]}
    pin = PINS["plans"][name]
    assert len(listing["bytes"]) + len(listing["floats"]) == pin["leaves"]
    assert [listing["bytes"][0], listing["floats"][0]] == pin["first"]
    assert [listing["bytes"][-1], listing["floats"][-1]] == pin["last"]
    assert hashlib.sha256(json.dumps(listing).encode()).hexdigest() == pin["sha256"]


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_logits_are_the_parents(name, one_thread):
    _, tiny = load(name)
    family = family_of(tiny)
    want = torch.from_numpy(np.load(HERE / "family_logits.npz")[f"{name}.fp32"])
    weights = make_weights(tiny, 7, "cpu")
    with exact_matmuls(), torch.no_grad():
        seq = family.sequence(tiny, item_of(name), weights, "cpu")
        assert seq.ids.shape[0] == 300
        assert [start for _, start in seq.served] == [200]
        got = family.logits(tiny, weights, seq, torch.tensor(ROWS), EXACT)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("name", CONFIGS)
def test_work_counts_are_the_parents(name):
    full, _ = load(name)
    pin = PINS["work"][name]
    family = family_of(full)
    for n in (1, 300, 2582, 3812):
        assert family.prefill_flops(full, n) == pin[f"prefill_flops {n}"]
    for t, c in ((1, 1000.0), (448, 448 * (3000 + 224.0))):
        assert family.decode_flops(full, t, c) == pin[f"decode_flops {t} {c!r}"]
    for p, c in ((1, 1000.0), (350, 448 * (3000 + 224.0))):
        assert family.decode_bytes(full, p, c) == pin[f"decode_bytes {p} {c!r}"]
    grid = pin.get("tower_grid")
    if grid is not None:
        size = family.served_size(480, 640, full["image_processor"], 28)
        assert [size[0] // 14, size[1] // 14] == grid
        assert family.tower_flops(full["vision_config"], *grid) == pin["tower_flops"]
        assert family.input_flops(full, {"grid": grid}) == pin["tower_flops"]
    assert family.input_flops(full, {}) == 0.0


@pytest.mark.parametrize("name", CONFIGS)
def test_metric_readers_are_the_parents(name):
    full, _ = load(name)
    run = synthetic_run(full, PINS["work"][name].get("tower_grid"))
    for metric, want in PINS["readers"][name].items():
        reader = spec.load_module(spec.BENCH_DIR / "metrics" / f"{metric}.py", f"pin_{metric}")
        assert reader.read(run) == want, metric


ALIAS = '''"""A family that is Mistral's under another name."""
from bench_torch.families.mistral import *  # noqa: F401,F403
'''


def test_a_cell_of_a_new_architecture_joins_by_files_alone(tmp_path, monkeypatch):
    """A family file, a configuration file, a traffic mix and a cell check,
    all new and in a directory of their own, make a cell that the harness
    loads and whose family it uses; the family here re-exports Mistral's,
    so every reading equals Mistral's."""
    full, tiny = load("mistral_7b_v0_3")
    g = torch.Generator().manual_seed(3)
    items = [{"seed": 11, "pieces": [{"ids": torch.randint(0, 256, (60,), generator=g).tolist()},
                                     {"ids": torch.randint(0, 256, (40,), generator=g).tolist(),
                                      "served": True}]}]
    mistral = family_of(full)
    want = {"compare": compare(tiny, items, "cpu", control=True),
            "config": mistral.program_config(full), "flops": mistral.decode_flops(full, 448, 1e6)}
    weights = make_weights(tiny, 5, "cpu")

    bench = tmp_path / "bench_torch"
    for sub in ("configs", "traffic", "checks", "families"):
        (bench / sub).mkdir(parents=True)
    for sub in ("drivers", "metrics"):
        (bench / sub).symlink_to(spec.BENCH_DIR / sub)
    (bench / "families" / "alias.py").write_text(ALIAS)
    cfg = json.loads((spec.BENCH_DIR / "configs" / "mistral_7b_v0_3.json").read_text())
    cfg["model"]["model_type"] = "alias"
    (bench / "configs" / "alias_7b.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "alias_mix.json").write_text(
        (spec.BENCH_DIR / "traffic" / "bundle.json").read_text())
    (bench / "checks" / "explain.alias_7b.alias_mix.json").write_text(
        (spec.BENCH_DIR / "checks" / "explain.mistral_7b_v0_3.bundle.json").read_text())
    benchmark = json.loads((ROOT / "BENCHMARK.json").read_text())
    benchmark["configs"] = [{"name": "alias_7b", "file": "bench_torch/configs/alias_7b.json"}]
    benchmark["workloads"] = [{"name": "explain.alias_7b.alias_mix", "config": "alias_7b",
                               "traffic": "alias_mix", "chips": 1}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(benchmark))
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setattr(spec, "BENCH_DIR", bench)
    monkeypatch.setattr(families, "FAMILY_DIR", bench / "families")

    cell = spec.load_cell("explain.alias_7b.alias_mix", tmp_path / "BENCHMARK.json")
    model = cell.config["model"]
    alias_tiny = dict(model, **cell.config["rehearsal"]["model"])
    family = family_of(model)
    assert Path(family.__file__) == bench / "families" / "alias.py"
    assert cell.driver().Driver is not None and cell.limits["min_compared"] == 300
    assert compare(alias_tiny, items, "cpu", control=True) == want["compare"]
    assert family.program_config(model) == want["config"]
    assert family.decode_flops(model, 448, 1e6) == want["flops"]
    got = make_weights(alias_tiny, 5, "cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(leaves(got), leaves(weights)))


def test_an_unknown_model_type_names_the_missing_path(tmp_path, monkeypatch):
    missing = re.escape(str(families.FAMILY_DIR / "no_such_family.py"))
    with pytest.raises(SystemExit, match=missing):
        family_of({"model_type": "no_such_family"})
    for odd in ("../configs/x", "_dense_gqa", "__init__", ""):
        with pytest.raises(SystemExit, match="model_type"):
            family_of({"model_type": odd})
    # A cell of such a configuration stops as it is loaded.
    cfg = json.loads((spec.BENCH_DIR / "configs" / "mistral_7b_v0_3.json").read_text())
    cfg["model"]["model_type"] = "no_such_family"
    (tmp_path / "odd.json").write_text(json.dumps(cfg))
    benchmark = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in benchmark["configs"]:
        if entry["name"] == "mistral_7b_v0_3":
            entry["file"] = str(tmp_path / "odd.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(benchmark))
    with pytest.raises(SystemExit, match="no_such_family.py"):
        spec.load_cell("explain.mistral_7b_v0_3.bundle", tmp_path / "BENCHMARK.json")


WITHOUT_PROGRAM = r"""
import json, sys
sys.path.insert(0, sys.argv[1])


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("vis_tpu_torch", "vis_tpu", "jax"):
            raise ImportError(f"the reference imported {name}")


sys.meta_path.insert(0, Refuse())
import torch
from bench_torch.families import family_of
from bench_torch.harness.check import compare
from bench_torch.harness.weights import make_weights

out = {}
for full, tiny, item in json.loads(sys.argv[2]):
    family = family_of(tiny)
    make_weights(tiny, 7, "cpu")
    readings = compare(tiny, [item], "cpu", control=True)
    assert readings["compared"] == 100, readings
    counts = [family.prefill_flops(full, 300), family.decode_flops(full, 448, 1e6),
              family.decode_bytes(full, 350, 1e6), family.input_flops(full, {"grid": [34, 46]})]
    out[tiny["model_type"]] = [readings["widest_gap"], readings["control_widest_gap"], counts]
held = sorted({m.split(".")[0] for m in sys.modules} & {"vis_tpu_torch", "vis_tpu", "jax"})
assert not held, held
print(json.dumps(out))
"""


def test_the_check_weights_and_counts_import_nothing_of_the_program():
    cases = [list(load(name)) + [item_of(name)] for name in CONFIGS]
    done = subprocess.run([sys.executable, "-c", WITHOUT_PROGRAM, str(ROOT), json.dumps(cases)],
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert sorted(got) == sorted(full["model_type"] for full, _, _ in cases)
    for full, tiny, item in cases:
        widest, control, counts = got[full["model_type"]]
        want = compare(tiny, [item], "cpu", control=True)  # here, with the program importable
        assert widest == pytest.approx(want["widest_gap"], rel=1e-5)
        assert control == pytest.approx(want["control_widest_gap"], rel=1e-5)
        family = family_of(full)
        assert counts[:3] == [family.prefill_flops(full, 300),
                              family.decode_flops(full, 448, 1e6),
                              family.decode_bytes(full, 350, 1e6)]
