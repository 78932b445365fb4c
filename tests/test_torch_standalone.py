"""The port stands on its own: its copies of the JAX package's device-free
modules behave as the originals.  The port side runs in one subprocess with
jax and vis_tpu both blocked (torch_port_runner.py); nothing here imports
torch.

- run_inspection on the mock provider through both packages, on the same
  images, over scenario x criticality x domain: the safety verdict (with
  every gate's result), the consensus and both agents' results are equal
  once the fields that carry a clock (defect ids, times) are dropped;
- the constraint tables of generic JSON and of every schema at a
  1024-token byte vocabulary are byte-equal, field by field;
- ByteTokenizer encodes and decodes alike;
- the host preprocess gives the same patches, bit for bit;
- the port's config: providers default to "cuda", configs/models.yaml's
  "tpu" reads as "cuda", and TORCH_DEVICE picks the torch device.
"""

import json

import numpy as np
import pytest
from PIL import Image

from vis_tpu.agents import reset_agent_cache
from vis_tpu.ops.preprocess import preprocess_image
from vis_tpu.orchestration.graph import run_inspection
from vis_tpu.serving.constrained import json_constraint_tables
from vis_tpu.serving.schema import SCHEMAS, schema_constraint_tables
from vis_tpu.serving.tokenizer import ByteTokenizer
from vis_tpu.utils.config import get_config
from torch_port import run_port

SCENARIOS = ("clean", "crack", "rust", "scratch")  # the mock backend's filename hints
CRITICALITIES = ("low", "medium", "high")
DOMAINS = ("general", "aerospace", "medical")
CASES = [(s, c, d) for s in SCENARIOS for c in CRITICALITIES for d in DOMAINS]
FIELDS = ("safety_verdict", "consensus", "inspector_result", "auditor_result",
          "requires_human_review", "has_critical_failure")
# Fields that carry the clock or the request, not the verdict.
VOLATILE = {"defect_id", "processing_time", "timestamp", "request_id", "inspection_id",
            "created_at", "start_time", "duration_ms"}
VOCAB = 1024
TEXTS = ["", "hello", '{"object_identified": "bolt"}', "héllo wörld ✓", "line\nbreak\t"]
IDS = [[], [104, 105], [256, 104, 257], [200, 195, 169, 1000, 33], [0, 255, 258, 261]]
PREPROCESS = [("clean", None), ("crack", 256), ("rust", 128)]


def _normalize(value):
    if isinstance(value, dict):
        return {k: _normalize(v) for k, v in value.items() if k not in VOLATILE}
    if isinstance(value, list):
        return [_normalize(v) for v in value]
    return value


def _image(tmp, scenario, seed):
    rng = np.random.default_rng(seed)
    arr = rng.integers(70, 190, size=(150, 200, 3), dtype=np.uint8)
    arr[40:80, 60:140] = [170, 90 + 20 * seed, 60]
    path = tmp / f"{scenario}_part.jpg"
    Image.fromarray(arr).save(path, quality=90)
    return str(path)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_standalone")
    images = {s: _image(tmp, s, i) for i, s in enumerate(SCENARIOS)}
    env = {"USE_MOCK_RESPONSES": "true", "LOG_TO_FILE": "false",
           "DATABASE_PATH": str(tmp / "jax.db"), "CHAT_HISTORY_DB": str(tmp / "jax_chat.db"),
           "REPORT_DIR": str(tmp / "jax_reports"), "LOG_DIR": str(tmp / "jax_logs")}
    with pytest.MonkeyPatch.context() as mp:
        for key, value in env.items():
            mp.setenv(key, value)
        get_config(reload=True)
        reset_agent_cache()
        try:
            states = [run_inspection(images[s], criticality=c, domain=d,
                                     user_notes="standalone parity") for s, c, d in CASES]
            jax_pipeline = [json.loads(json.dumps({k: st.get(k) for k in FIELDS}, default=str))
                            for st in states]
        finally:
            mp.undo()
            get_config(reload=True)
            reset_agent_cache()
    tok = ByteTokenizer(vocab_size=VOCAB)
    tables = {"json": json_constraint_tables(tok, VOCAB)}
    tables.update({name: schema_constraint_tables(tok, VOCAB, name) for name in SCHEMAS})
    ref = {
        "pipeline": jax_pipeline,
        "tables": tables,
        "encode": [tok.encode(s) for s in TEXTS],
        "decode": [tok.decode(ids) for ids in IDS],
        "preprocess": [preprocess_image(images[s], max_image_dim=m, use_native=False)
                       for s, m in PREPROCESS],
    }
    port_dir = tmp / "port"
    port_dir.mkdir()
    port = run_port("standalone", {
        "workdir": np.array(str(port_dir)),
        "cases": np.array(json.dumps([(images[s], c, d) for s, c, d in CASES])),
        "fields": np.array(json.dumps(FIELDS)),
        "vocab": np.array(VOCAB),
        "texts": np.array(json.dumps(TEXTS)),
        "ids": np.array(json.dumps(IDS)),
        "preprocess": np.array(json.dumps([(images[s], m) for s, m in PREPROCESS])),
    }, tmp)
    return ref, port


@pytest.mark.parametrize("index", range(len(CASES)),
                         ids=["-".join(case) for case in CASES])
def test_mock_pipeline_matches_jax_package(sides, index):
    ref, port = sides
    got = _normalize(json.loads(str(port["pipeline"]))[index])
    want = _normalize(ref["pipeline"][index])
    for field in FIELDS:
        assert got[field] == want[field], field
    assert want["safety_verdict"]["verdict"] in {"SAFE", "UNSAFE", "REQUIRES_HUMAN_REVIEW"}


@pytest.mark.parametrize("name", ["json", *SCHEMAS])
def test_constraint_tables_byte_equal(sides, name):
    ref, port = sides
    table = ref["tables"][name]
    fields = {k: v for k, v in vars(table).items() if v is not None}
    got = {k[len(f"tables/{name}/"):] for k in port if k.startswith(f"tables/{name}/")}
    assert got == set(fields)
    for field, value in fields.items():
        want = np.asarray(value)
        have = port[f"tables/{name}/{field}"]
        assert have.dtype == want.dtype and have.shape == want.shape, field
        assert have.tobytes() == want.tobytes(), field


def test_byte_tokenizer_encodes_and_decodes_alike(sides):
    ref, port = sides
    assert json.loads(str(port["encode"])) == ref["encode"]
    assert json.loads(str(port["decode"])) == ref["decode"]


@pytest.mark.parametrize("index", range(len(PREPROCESS)))
def test_host_preprocess_patches_bit_equal(sides, index):
    ref, port = sides
    want = ref["preprocess"][index]
    assert port[f"preprocess{index}/grid"].tolist() == [want.grid_t, want.grid_h, want.grid_w]
    have = port[f"preprocess{index}/patches"]
    assert have.dtype == want.patches.dtype
    assert have.tobytes() == want.patches.tobytes()


def test_providers_default_to_cuda(sides):
    _, port = sides
    assert json.loads(str(port["defaults"])) == {
        "vlm_inspector_provider": "cuda", "vlm_auditor_provider": "cuda",
        "explainer_provider": "cuda", "torch_device": "cuda:0"}


def test_models_yaml_tpu_provider_reads_as_cuda(sides):
    _, port = sides
    mapped = json.loads(str(port["yaml"]))
    keys = ("VLM_INSPECTOR_PROVIDER", "VLM_AUDITOR_PROVIDER", "EXPLAINER_PROVIDER")
    for provider, want in (("tpu", "cuda"), ("TPU", "cuda"), ("cuda", "cuda"),
                           ("mock", "mock")):
        assert mapped[provider] == {key: want for key in keys}, provider


def test_torch_device_setting(sides):
    _, port = sides
    assert str(port["torch_device_env"]) == "cpu"
