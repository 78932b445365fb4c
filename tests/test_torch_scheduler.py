"""The port's continuous-batching scheduler and text engine against the
JAX package: the explainer's report bundle (narration, counterfactual and
decision support, submitted concurrently, greedy) through the paged
scheduler, on the same carried weights (the tiny Llama of
test_torch_llama.py: int4 layers and an int8 vocab head).

The embedding table stays float here.  An int8 embedding returns bf16 rows,
which puts the whole residual stream in bf16; the two frameworks then round
sums taken in different orders to different bf16 values now and then, and
over 48 greedy tokens at a 944-token context a near-tie between two tokens
flips (measured: one token in the narration).  With a float residual
stream the only bf16 rounding is of each int4 matmul's input, and the
streams stay token-exact.  The int8 embedding gather itself is compared in
test_torch_int8.py and runs in test_torch_llama.py.

Every output is compared exactly (token-exact text) against the JAX
scheduler's, as tests/test_scheduled_engine.py pins the JAX scheduler
against the JAX engine, and against the port's own unbatched decode of the
same three calls.  The narration prompt is longer than a slot's room, so
it also takes the prompt truncation against the pool's per-slot room.
Also here: prompts through the scheduler's own whole-prompt prefill
(``submit``) under slot and page churn (7 requests, 4 slots, a pool that
holds 4 of them), against the JAX scheduler and the port's unbatched
decode, token-exact; and settings the port does not implement raise
NotImplementedError instead of changing its numbers.
"""

import json

import numpy as np
import pytest

from vis_tpu.agents.explainer import ExplainerAgent
from vis_tpu.schemas.models import VLMAnalysisResult
from vis_tpu.serving.engine import Engine, EngineBackend
from vis_tpu.serving.scheduler import ContinuousBatchingScheduler
from vis_tpu.serving.schema import SCHEMAS
from vis_tpu.serving.tokenizer import ByteTokenizer
from vis_tpu.utils.config import config as app_config
from test_torch_llama import OVERRIDES, carried_params, tiny_llama
from torch_port import flatten_params, run_port

FIXTURE = {
    "result": {
        "object_identified": "steel bracket", "overall_condition": "damaged",
        "defects": [{
            "defect_id": "D1", "type": "crack", "location": "left flange",
            "severity": "HIGH", "confidence": "high", "safety_impact": "CRITICAL",
            "reasoning": "load-bearing member", "recommended_action": "replace the bracket",
        }],
        "overall_confidence": "high",
    },
    "verdict": {"verdict": "UNSAFE", "requires_human": False},
}
# The same serving profile on both sides: 4 slots, 128-token pages, a
# 1024-token slot window, 32-step chunks; explainer budget 48, greedy.
SERVING = dict(max_cache_tokens=1024, lookahead=8, decode_batch_size=4, paged_kv_cache=True,
               kv_page_size=128, kv_pool_tokens=4096, scheduler_decode_chunk=32,
               min_json_tokens=0)
APP = dict(constrained_json=True, constrained_schema=True, explainer_max_tokens=48,
           explainer_temperature=0.0, constrained_json_min_tokens=0, kv_page_size=128,
           kv_pool_tokens=4096, scheduler_decode_chunk=32, paged_kv_cache=True,
           decode_batch_size=4, constrained_lookahead=8)
# With 48-step chunks (the bench profile's) a slot's room is tighter than
# the cache's: a long prompt is cut to 1024 - 48 - 48 = 928 tokens, not the
# cache's 1024 - 48 - 32 = 944, or the scheduler would refuse it.
TIGHT_CHUNK, LONG_PROMPT = 48, "x" * 2000
ENV = {"CONSTRAINED_JSON": "true", "CONSTRAINED_SCHEMA": "true", "EXPLAINER_MAX_TOKENS": "48",
       "EXPLAINER_TEMPERATURE": "0", "CONSTRAINED_JSON_MIN_TOKENS": "0",
       "CONSTRAINED_LOOKAHEAD": "8", "LOG_TO_FILE": "false"}
KINDS = ("narration", "counterfactual", "decision")


class _Recorder:
    def __init__(self, backend):
        self.backend, self.name, self.outputs = backend, backend.name, {}

    def generate(self, prompt, image_path=None, **kwargs):
        text = self.backend.generate(prompt, image_path, **kwargs)
        kind = ("decision" if kwargs.get("json_schema") else
                "narration" if "STRUCTURED FINDINGS" in prompt else "counterfactual")
        self.outputs[kind] = text
        return text


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    config = tiny_llama()
    params = carried_params(config, 7, int8_embedding=False)
    fixture = dict(FIXTURE)
    result = VLMAnalysisResult(**fixture["result"])
    fixture["consensus"] = {"combined_defects": [result.defects[0].model_dump()],
                            "models_agree": True, "agreement_score": 0.95}
    with pytest.MonkeyPatch.context() as mp:
        for name, value in APP.items():
            mp.setattr(app_config, name, value)
        engine = Engine("jax-scheduled", config, params,
                        ByteTokenizer(vocab_size=config.vocab_size), max_cache_tokens=1024)
        engine.attach_scheduler(num_slots=4, paged=True)
        try:
            recorder = _Recorder(EngineBackend(engine))
            ExplainerAgent(recorder).generate_report_bundle(
                result, result, fixture["consensus"], fixture["verdict"])
        finally:
            engine.detach_scheduler()
        mp.setattr(app_config, "scheduler_decode_chunk", TIGHT_CHUNK)
        engine.attach_scheduler(num_slots=4, paged=True)
        try:
            recorder.outputs["room"] = [engine._prefill_request(
                LONG_PROMPT, None, max_tokens=48, max_image_dim=512, prompt_only_cache=only
            )[3] for only in (False, True)]
        finally:
            engine.detach_scheduler()
    inp = flatten_params(params, "params", {})
    inp.update(config=np.array(json.dumps(OVERRIDES)), env=np.array(json.dumps(ENV)),
               settings=np.array(json.dumps(SERVING)),
               tight=np.array(json.dumps([TIGHT_CHUNK, LONG_PROMPT])),
               fixture=np.array(json.dumps(fixture, default=str)))
    port = run_port("bundle", inp, tmp_path_factory.mktemp("torch_bundle"))
    return recorder.outputs, {k: json.loads(str(v)) for k, v in port.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_bundle_matches_jax_scheduler(sides, kind):
    jax_out, port = sides
    assert port["batched"][kind] == jax_out[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_bundle_matches_port_unbatched(sides, kind):
    _, port = sides
    assert port["batched"][kind] == port["sequential"][kind]


def test_bundle_ran_batched(sides):
    """Three admissions, decoded together, and the bundle's return value
    equals the sequential calls' (the JAX explainer's contract)."""
    jax_out, port = sides
    stats = port["stats"]
    assert stats["admitted"] == 3 and stats["max_live"] >= 2, stats
    bundle, sequential = port["bundle"]
    assert bundle == sequential
    doc = json.loads(port["batched"]["decision"])
    assert list(doc) == [k for k, _ in SCHEMAS["decision_support"].props]


def test_prompt_truncated_to_the_slot_room(sides):
    """Scheduler hand-offs cut a long prompt to the pool's per-slot room,
    as the JAX engine does; unbatched requests keep the cache's room."""
    jax_out, port = sides
    assert port["room"] == jax_out["room"] == [944, 928]


@pytest.fixture(scope="module")
def refusals(tmp_path_factory):
    out = run_port("refusals", {"config": np.array(json.dumps(OVERRIDES))},
                   tmp_path_factory.mktemp("torch_refusals"))
    return {k: str(v) for k, v in out.items()}


@pytest.mark.parametrize("role", ["explainer", "inspector"])
def test_kv_quantization_int8_refused(refusals, role):
    """The reference stores every KV cache as int8 under KV_QUANTIZATION=int8;
    the port would keep bf16 and give other numbers, so build_engine refuses."""
    assert "KV_QUANTIZATION=int8" in refusals[f"kv_int8/{role}"]


@pytest.mark.parametrize("setting", ["quantization_int8", "dense_scheduler", "chunked_prefill"])
def test_unported_settings_refused(refusals, setting):
    assert refusals[setting], setting


CHURN_PROMPTS = (
    ("short", 6),
    ("a somewhat longer prompt about corrosion on the lower panel with extra "
     "descriptive detail to vary the prefill length", 14),
    ("medium length prompt here", 9),
    ("req four", 5),
    ("request five concerns the weld seam and its porosity profile", 12),
    ("six", 7),
    ("the seventh request asks about fastener torque marks", 10),
)
CHURN = dict(num_slots=4, max_len=512, page_size=128, pool_tokens=512, decode_chunk=32)


@pytest.fixture(scope="module")
def churn(tmp_path_factory):
    config = tiny_llama()
    params = carried_params(config, 7, int8_embedding=False)
    tokenizer = ByteTokenizer(vocab_size=config.vocab_size)
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (("kv_page_size", 128), ("kv_pool_tokens", 512),
                            ("scheduler_decode_chunk", 32), ("chunked_prefill_tokens", 0)):
            mp.setattr(app_config, name, value)
        sched = ContinuousBatchingScheduler(config, params, tokenizer, num_slots=4,
                                            max_len=512, paged=True)
        sched.start()
        try:
            requests = [sched.submit(p, max_tokens=b) for p, b in CHURN_PROMPTS]
            for request in requests:
                while request.out.get(timeout=300) is not None:
                    pass
        finally:
            sched.stop()
    jax_out = [tokenizer.decode(r.generated) for r in requests]
    inp = flatten_params(params, "params", {})
    inp.update(config=np.array(json.dumps(OVERRIDES)),
               jobs=np.array(json.dumps(CHURN_PROMPTS)), scheduler=np.array(json.dumps(CHURN)))
    port = run_port("churn", inp, tmp_path_factory.mktemp("torch_churn"))
    return jax_out, {k: json.loads(str(v)) if v.dtype.kind == "U" else v
                     for k, v in port.items()}


def test_churn_matches_jax_scheduler(churn):
    jax_out, port = churn
    assert port["errors"] == [None] * len(CHURN_PROMPTS)
    assert port["scheduled"] == jax_out


def test_churn_matches_port_unbatched(churn):
    _, port = churn
    assert port["scheduled"] == port["unbatched"]


def test_churn_recycled_slots_and_pages(churn):
    """Seven requests through four slots in a 4-page pool: every page came
    back, and the slots were shared and refilled."""
    _, port = churn
    free, total = port["free_pages"].tolist()
    assert free == total == 4
    assert port["stats"]["admitted"] == len(CHURN_PROMPTS)
    assert port["stats"]["max_live"] >= 2
