"""The port's slices as a whole, through the port's own entry point
(vis_tpu_torch.orchestration.graph.run_inspection): the inspector on the
provider "cuda" (TORCH_DEVICE=cpu), the auditor and the explainer on the
mock provider, the small Qwen2.5-VL profile with int4 layers and vocab
head, schema-constrained lookahead decode and device preprocessing; and
the explainer on the provider "cuda" under the bench's batching profile,
which must reach the port's text engine with its paged scheduler.  Each
runs in one subprocess with jax and vis_tpu blocked."""

import json

import numpy as np
import pytest
from PIL import Image

from vis_tpu.serving.schema import SCHEMAS
from torch_port import run_port


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    # The conftest's sample_image_path photo (a 128x96 textured JPEG).
    tmp = tmp_path_factory.mktemp("torch_pipeline")
    rng = np.random.default_rng(0)
    base = rng.integers(60, 200, size=(96, 128, 3), dtype=np.uint8)
    base[30:60, 40:90] = [200, 40, 40]
    base[10:20, :] = [30, 30, 30]
    image = tmp / "sample.jpg"
    Image.fromarray(base).save(image, quality=90)
    return run_port("pipeline", {"image": np.array(str(image)),
                                 "workdir": np.array(str(tmp))}, tmp)


def test_run_inspection_returns_a_verdict(run):
    assert str(run["verdict"]) in {"SAFE", "UNSAFE", "REQUIRES_HUMAN_REVIEW"}


def test_inspector_went_through_the_port(run):
    assert str(run["backend"]).startswith("cuda:")
    assert not bool(run["analysis_failed"])


def test_inspector_json_has_the_schema_keys(run):
    doc = json.loads(str(run["raw"]))
    assert list(doc) == [key for key, _ in SCHEMAS["inspection"].props]


def test_no_kernel_launched_on_cpu(run):
    assert run["launches"].tolist() == [0, 0, 0, 0, 0]


def test_jax_never_loaded(run):
    assert not bool(run["jax_live"])


@pytest.fixture(scope="module")
def explainer(tmp_path_factory):
    return run_port("explainer_routing", {}, tmp_path_factory.mktemp("torch_explainer"))


def test_explainer_provider_cuda_reaches_the_text_engine(explainer):
    assert str(explainer["backend"]).startswith("cuda:")
    assert str(explainer["inspector_backend"]) == "mock"
    assert bool(explainer["text_only"]) and bool(explainer["int8_head"])


def test_explainer_engine_has_the_paged_scheduler(explainer):
    """BATCHING_ROLES=explainer: 3 slots over a 4992-token pool of 128-token
    pages, 48-step chunks, the generic and decision_support grammars stacked."""
    sched = json.loads(str(explainer["scheduler"]))
    assert sched == {"slots": 3, "pages": 39, "page": 128, "chunk": 48,
                     "decision_support": True, "generic": True}
