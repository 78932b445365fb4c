"""The port refuses a checkpoint it cannot load.

The reference's build_engine serves real weights when CHECKPOINT_DIR holds
safetensors for the role's model (``vis_tpu/serving/engine.py``
``build_engine``, through ``vis_tpu.models.loader.find_checkpoint``).  The
port does not load checkpoints yet, so its build_engine raises there rather
than build random weights in their place; where no checkpoint is found it
builds as before.  Its copy of find_checkpoint must find what the
reference's finds on the same directory layouts.
"""

import json

import numpy as np
import pytest

from torch_port import run_port
from vis_tpu.models.loader import find_checkpoint

MODELS = {"inspector": "Qwen/Qwen2.5-VL-7B-Instruct",
          "explainer": "meta-llama/Llama-3.1-8B-Instruct"}
MODEL = MODELS["inspector"]
LAYOUTS = {  # name: {file under that layout's root: contents}
    "double_underscore": {"Qwen__Qwen2.5-VL-7B-Instruct/model.safetensors": ""},
    "basename": {"Qwen2.5-VL-7B-Instruct/model-00001-of-00002.safetensors": "",
                 "Qwen2.5-VL-7B-Instruct/model-00002-of-00002.safetensors": ""},
    "full_id": {"Qwen/Qwen2.5-VL-7B-Instruct/model.safetensors": ""},
    "config_only": {"Qwen__Qwen2.5-VL-7B-Instruct/config.json": "{}"},
    "empty": {},
}
SERVED = {"Qwen__Qwen2.5-VL-7B-Instruct/model.safetensors": "",
          "Llama-3.1-8B-Instruct/model.safetensors": ""}
OTHER = {"someone__another-model/model.safetensors": ""}


def _write(root, files):
    root.mkdir(parents=True, exist_ok=True)
    for name, text in files.items():
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        (root / name).write_text(text)
    return root


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_checkpoint")
    layouts = tmp / "layouts"
    for name, files in LAYOUTS.items():
        _write(layouts / name, files)
    found = {}
    for name in LAYOUTS:
        hit = find_checkpoint(MODEL, layouts / name)
        found[name] = "" if hit is None else str(hit.relative_to(layouts / name))
    port = run_port("checkpoint", {
        "root": np.array(str(layouts)), "layouts": np.array(json.dumps(list(LAYOUTS))),
        "model": np.array(MODEL), "models": np.array(json.dumps(MODELS)),
        "served": np.array(str(_write(tmp / "served", SERVED))),
        "other": np.array(str(_write(tmp / "other", OTHER))),
    }, tmp)
    return found, {k: str(v) for k, v in port.items()}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_find_checkpoint_matches_the_reference(sides, layout):
    found, port = sides
    assert port[f"found/{layout}"] == found[layout]
    assert bool(found[layout]) == (layout not in ("config_only", "empty"))


@pytest.mark.parametrize("role", list(MODELS))
def test_build_engine_refuses_a_checkpoint_it_cannot_load(sides, role):
    _, port = sides
    assert "safetensors" in port[f"refused/{role}"], port[f"refused/{role}"]


@pytest.mark.parametrize("role", list(MODELS))
def test_build_engine_unchanged_without_a_checkpoint(sides, role):
    _, port = sides
    assert json.loads(port[f"unchanged/{role}"]) == [True, True]
