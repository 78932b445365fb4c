"""The decode paths of the config's defaults in the port against the JAX
package: free-form greedy and sampled decode, schema-constrained decode
without a lookahead window (CONSTRAINED_LOOKAHEAD=0), and KV-cached chat
sessions, on both engines.

- Loops, on the tiny Qwen2.5-VL text config (M-RoPE, qkv bias) and the tiny
  Llama config (llama3 RoPE scaling, vocab 512), both widened to hidden 128
  (intermediate 256) so that the int8 kernels' shape rule takes every
  projection: two prompts (21 and 34 tokens) prefilled into one two-row
  dense cache, then ``decode_loop_scan``, ``decode_loop_scan_sampled``
  (temperatures 0.7 and 0, per row) and ``decode_loop_scan_constrained``
  under the inspection schema's DFA (greedy, and sampled at 0.7) against
  their JAX counterparts, the JAX side's per-step uniforms replayed into
  the port.  f32 weights: 12 steps, tokens and cursors exactly equal, the
  final logits within 3e-4, the port's host cursor mirror equal to its
  device cursors.  Two more f32 runs: one whose EOS (a token row 0 emits
  at step 4) ends the chunk early while row 1 has a budget of 0, and one
  with row budgets 3 and 7.  int4 (int8 vocab table for Llama, as the
  explainer's) and int8 weights: one step, the step's logits within
  2^-6 * max|ref| (bf16 keeps 8 significant bits, and both sides round
  every quantized matmul's input to bf16, so a last-bit difference of an
  f32 sum taken in another order can flip a rounding) with the argmax and
  the token equal.  At int8 the JAX side runs its Pallas kernel bodies in
  interpret mode (``test_torch_int8_engine._interpret``): off the TPU it
  would take neither kernel.
- Engines, f32, DECODE_CHUNK=5 so that every request chains chunks: the
  tiny Qwen2.5-VL engine with an image and a tiny Llama text engine through
  ``Engine.generate`` free-form greedy and sampled (0.7), and under the
  inspection schema with CONSTRAINED_LOOKAHEAD=0, greedy and sampled
  (0.1); the Llama engine also free-form greedy at DECODE_CHUNK=64.  The
  Mllama loop engine (test_torch_engine_mllama.py's tiny engine) in the
  same modes, among them the two requests it refused before (``no_window``
  and ``sampled_free``).  Sampled requests replay the JAX engine's own
  uniforms: PRNGKey(0) folded by the chunk's index, split per step.
  Tokens and texts are exactly equal; the health check passes on both
  engines.
- Chat, on tests/test_chat_session.py's engine: two ``chat_turn``s on one
  session give the JAX engine's tokens, positions and cursor, once with
  the tokenizer's EOS and once with an EOS the first reply emits inside
  its first chunk (the cursor rewound past it); a follow-up turn equals
  ``generate`` on the re-prefilled transcript; a turn past the session's
  cache raises RuntimeError; ``last_decode_tokens`` and
  ``decode_tokens_total`` count chat turns.
- Pipeline: ``run_inspection`` on the small CPU profiles with every decode
  setting at the config's default (free-form sampled decode for all three
  roles, short budgets), the port's against the JAX package's: the same
  verdict and ``analysis_failed`` flags, and no role's backend raised.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vis_tpu.models.common.decoder import (
    DecodeConstraint,
    decode_loop_scan,
    decode_loop_scan_constrained,
    decode_loop_scan_sampled,
    fuse_stacked_projections,
    init_decoder_params,
    prefill_scan,
    quantize_stacked_params,
    stack_decoder_layers,
)
from vis_tpu.models.common.layers import KVCache, embed
from vis_tpu.models.llama.config import llama_tiny
from vis_tpu.models.qwen2_5_vl import Qwen25VLConfig, init_params as init_qwen25
from vis_tpu.serving.engine import Engine
from vis_tpu.serving.engine_mllama import MllamaEngine
from vis_tpu.serving.schema import SCHEMAS, schema_constraint_tables
from vis_tpu.serving.tokenizer import ByteTokenizer
from vis_tpu.utils.config import get_config
from test_torch_engine_mllama import _image, config_json, engine_config, recording_tokenizer
from test_torch_int8_engine import _interpret
from torch_port import flatten_params, mllama_params, run_port

REPO = Path(__file__).resolve().parents[1]
VOCAB, EOS = 512, 256
# Loops: two prompts in one dense cache; EOS_NEVER is past every vocab id.
PROMPTS, S_PAD, MAX_LEN, STEPS, EOS_NEVER = (21, 34), 48, 128, 12, VOCAB
LOOP_PROFILES = ("qwen", "llama")
VARIANTS = ("f32", "int4", "int8")
LOOP_MODES = ("greedy", "sampled", "constrained", "constrained_sampled")
EXIT_MODES = ("eos", "budget")  # f32 only
ROW_TEMPERATURES, LOOP_TEMPERATURE = (0.7, 0.0), 0.7
# Engines: chunks of 5 steps; sampled requests take CHUNKS chunks of draws.
CHUNK, CHUNKS, MAX_CACHE = 5, 40, 1024
FREE_TOKENS, SCHEMA_TOKENS = 12, 160
ENGINE_MODES = {  # mode -> (image?, decode chunk, generate kwargs)
    "greedy": (True, CHUNK, dict(temperature=0.0, max_tokens=FREE_TOKENS)),
    "sampled": (True, CHUNK, dict(temperature=0.7, max_tokens=FREE_TOKENS)),
    "schema": (True, CHUNK, dict(temperature=0.0, json_mode=True, json_schema="inspection",
                                 max_tokens=SCHEMA_TOKENS)),
    "schema_sampled": (True, CHUNK, dict(temperature=0.1, json_mode=True,
                                         json_schema="inspection", max_tokens=SCHEMA_TOKENS)),
    "greedy_whole": (False, 64, dict(temperature=0.0, max_tokens=FREE_TOKENS)),
}
ENGINES = {"qwen": ("greedy", "sampled", "schema", "schema_sampled"),
           "llama": tuple(ENGINE_MODES),
           "mllama": ("greedy", "sampled", "schema", "schema_sampled")}
# The Mllama requests the port refused before this slice.
MLLAMA_ALIASES = {"sampled_free": "sampled", "no_window": "schema"}
PROMPT, MAX_IMAGE_DIM = "Inspect the part.", 112
# Chat: tests/test_chat_session.py's engine and turns.
CHAT_SYSTEM, CHAT_TURNS, CHAT_TOKENS = "Context: one crack on the bracket.", ("where?",
                                                                             "severity?"), 10
CHAT_KINDS = ("plain", "eos")


def _widened(config):
    """A tiny decoder at hidden 128 (intermediate 256; M-RoPE sections
    resized to the 32-wide heads)."""
    extra = {"mrope_section": (4, 6, 6)} if config.mrope_section else {}
    return dataclasses.replace(config, vocab_size=VOCAB, hidden_size=128,
                               intermediate_size=256, **extra)


def loop_configs():
    return {"qwen": _widened(Qwen25VLConfig.tiny().text), "llama": _widened(llama_tiny())}


def decoder_json(config) -> str:
    """A DecoderConfig's fields as JSON (the port makes them f32)."""
    fields = {f.name: getattr(config, f.name) for f in dataclasses.fields(config)
              if f.name != "dtype"}
    return json.dumps(fields)


def _random_stack(config, seed):
    """init_decoder_params with random norms (near 1) and biases, stacked
    and fused: the float layout every variant starts from."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if "norm" in name:
            return jnp.asarray(1.0 + 0.1 * noise, leaf.dtype)
        if "bias" in name:
            return jnp.asarray(0.02 * noise, leaf.dtype)
        return leaf

    params = jax.tree_util.tree_map_with_path(
        fill, init_decoder_params(config, jax.random.PRNGKey(seed)))
    return fuse_stacked_projections(stack_decoder_layers(params))


def _variant(profile, stacked, variant):
    if variant == "f32":
        return stacked
    vocab = "int8" if (variant == "int8" or profile == "llama") else "int4"
    return quantize_stacked_params(stacked, quantize_embeddings=True, mode=variant,
                                   vocab_mode=vocab)


def _inspection_tables():
    return schema_constraint_tables(ByteTokenizer(vocab_size=VOCAB), VOCAB, "inspection")


def _loop_uniforms(key, steps, rows):
    """The per-step uniforms the JAX loops draw from ``key``: split per step."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (rows, VOCAB), jnp.float32, 1e-20, 1.0)))
    return np.stack(out)


def _loop_runs(config, params, ids, variant, inp, prefix):
    """Prefill the two prompts, then each loop mode from the same cache;
    returns the JAX side's outputs under ``prefix``."""
    call = _interpret if variant == "int8" else (lambda fn, *a, **k: fn(*a, **k))
    ref = {}
    cache = KVCache.create(config.num_layers, len(PROMPTS), MAX_LEN, config.num_kv_heads,
                           config.head_dim_, dtype=config.dtype)
    positions = jnp.broadcast_to(jnp.arange(S_PAD, dtype=jnp.int32), (len(PROMPTS), S_PAD))
    logits, cache = call(prefill_scan, config, params, embed(jnp.asarray(ids),
                                                             params["embed_tokens"]),
                         positions, cache, jnp.asarray(PROMPTS, jnp.int32))
    tables = _inspection_tables()
    start = jnp.asarray(PROMPTS, jnp.int32)
    steps = STEPS if variant == "f32" else 1
    modes = LOOP_MODES + (EXIT_MODES if variant == "f32" else ())
    for mode in modes:
        key = jax.random.PRNGKey(21)
        budget, eos = None, EOS_NEVER
        if mode == "eos":
            row0 = ref[f"{prefix}/greedy/tokens"][0].tolist()
            eos = row0[4]
            budget = [STEPS, 0]
        elif mode == "budget":
            budget = [3, 7]
        kwargs = dict(eos_id=eos, budget=None if budget is None else jnp.asarray(budget,
                                                                                 jnp.int32))
        if mode.startswith("constrained"):
            constraint = DecodeConstraint(
                token_ok=jnp.asarray(tables.token_ok), token_trans=jnp.asarray(tables.token_trans),
                cost_after=jnp.asarray(tables.cost_after),
                state=jnp.full((2,), tables.init_state, jnp.int32),
                remaining=jnp.asarray([160, 150], jnp.int32), active=jnp.ones((2,), bool),
                min_remaining=jnp.asarray([60, 150], jnp.int32))
            if mode == "constrained_sampled":
                kwargs.update(key=key, temperature=jnp.float32(LOOP_TEMPERATURE))
            tokens, last, out_cache, con = call(
                decode_loop_scan_constrained, config, params, logits, start, cache, constraint,
                steps, **kwargs)
            ref[f"{prefix}/{mode}/state"] = np.asarray(con.state)
        elif mode == "sampled":
            tokens, last, out_cache, _ = call(
                decode_loop_scan_sampled, config, params, logits, start, cache, key,
                jnp.asarray(ROW_TEMPERATURES, jnp.float32), steps, **kwargs)
        else:
            tokens, last, out_cache = call(decode_loop_scan, config, params, logits, start,
                                           cache, steps, **kwargs)
        ref[f"{prefix}/{mode}/tokens"] = np.asarray(tokens).astype(np.int64)
        ref[f"{prefix}/{mode}/logits"] = np.asarray(last.astype(jnp.float32))
        ref[f"{prefix}/{mode}/lengths"] = np.asarray(out_cache.lengths)
        inp[f"{prefix}/{mode}/exit"] = np.array([eos, -1 if budget is None else budget[0],
                                                 -1 if budget is None else budget[1]])
    inp[f"{prefix}/steps"] = np.array(steps)
    return ref


def _loops_side(inp, ref):
    rng = np.random.default_rng(29)
    tables = _inspection_tables()
    for name in ("token_ok", "token_trans", "cost_after"):
        inp[f"loops/tables/{name}"] = getattr(tables, name)
    inp["loops/init_state"] = np.array(tables.init_state)
    ids = np.zeros((len(PROMPTS), S_PAD), np.int64)
    for row, n in enumerate(PROMPTS):
        ids[row, :n] = rng.integers(10, 256, n)
    inp["loops/ids"] = ids
    inp["loops/uniforms"] = _loop_uniforms(jax.random.PRNGKey(21), STEPS, len(PROMPTS))
    for profile, config in loop_configs().items():
        inp[f"loops/{profile}/config"] = np.array(decoder_json(config))
        stacked = _random_stack(config, 31 if profile == "qwen" else 37)
        for variant in VARIANTS:
            params = _variant(profile, stacked, variant)
            prefix = f"loops/{profile}/{variant}"
            flatten_params(params, f"{prefix}/params", inp)
            ref.update(_loop_runs(config, params, ids, variant, inp, prefix))


def _engine_uniforms(vocab):
    """The JAX engines' sampled uniforms, chunk after chunk: PRNGKey(0)
    folded by the chunk's index, split per step of a CHUNK-step chunk."""
    out = []
    for chunk in range(CHUNKS):
        key = jax.random.fold_in(jax.random.PRNGKey(0), chunk)
        for _ in range(CHUNK):
            key, sub = jax.random.split(key)
            out.append(np.asarray(jax.random.uniform(sub, (1, vocab), jnp.float32, 1e-20, 1.0)))
    return np.stack(out)


def _qwen_engine_config():
    """The tiny Qwen2.5-VL with the byte tokenizer's special ids."""
    return dataclasses.replace(Qwen25VLConfig.tiny(), image_token_id=261,
                               vision_start_token_id=259, vision_end_token_id=260,
                               eos_token_id=EOS)


def _random_leaves(tree, rng):
    """Every leaf random (norms near 1, biases small), as
    test_torch_qwen25vl.py draws them."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in paths:
        name = jax.tree_util.keystr(path)
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if "norm" in name or "ln_q" in name:
            leaves.append(jnp.asarray(1.0 + 0.1 * noise))
        elif "bias" in name:
            leaves.append(jnp.asarray(0.02 * noise))
        else:
            leaves.append(jnp.asarray(0.05 * noise))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _settings_env(mp, chunk):
    for name, value in (("CONSTRAINED_LOOKAHEAD", 0), ("DECODE_CHUNK", chunk),
                        ("DEVICE_PREPROCESS", "false"), ("QUANTIZATION", "none"),
                        ("CONSTRAINED_JSON_MIN_TOKENS", 0)):
        mp.setenv(name, str(value))
    get_config(reload=True)


def _jax_engine(profile, params, tok):
    if profile == "qwen":
        config = _qwen_engine_config()
        return Engine("tiny-qwen", config.text, None, tok, vlm_config=config,
                      vlm_params=params, max_cache_tokens=MAX_CACHE)
    if profile == "llama":
        return Engine("tiny-llama", dataclasses.replace(llama_tiny(), vocab_size=VOCAB), params,
                      tok, max_cache_tokens=MAX_CACHE)
    return MllamaEngine("tiny-mllama", engine_config(), params, tok, max_cache_tokens=MAX_CACHE)


def _engines_side(inp, ref, image):
    """Each engine's modes on the JAX side; the weights the JAX engine
    serves (stacked, fused) go to the port."""
    rng = np.random.default_rng(41)
    raw = {"qwen": _random_leaves(init_qwen25(_qwen_engine_config(), jax.random.PRNGKey(2)), rng),
           "llama": _random_leaves(init_decoder_params(dataclasses.replace(
               llama_tiny(), vocab_size=VOCAB), jax.random.PRNGKey(3)), rng),
           "mllama": mllama_params(engine_config(), 11)}
    inp["engines/uniforms"] = _engine_uniforms(VOCAB)
    inp["engines/modes"] = np.array(json.dumps(ENGINE_MODES))
    inp["engines/image"] = np.array(image)
    inp["engines/mllama_config"] = np.array(config_json(engine_config()))
    with pytest.MonkeyPatch.context() as mp:
        try:
            for profile, modes in ENGINES.items():
                for chunk in sorted({ENGINE_MODES[mode][1] for mode in modes}):
                    _settings_env(mp, chunk)  # the engine reads DECODE_CHUNK once
                    tok = recording_tokenizer(VOCAB)
                    engine = _jax_engine(profile, raw[profile], tok)
                    for mode in modes:
                        with_image, mode_chunk, kwargs = ENGINE_MODES[mode]
                        if mode_chunk != chunk:
                            continue
                        text = engine.generate(PROMPT, image if with_image else None,
                                               max_image_dim=MAX_IMAGE_DIM, **kwargs)
                        ref[f"engines/{profile}/{mode}/text"] = text
                        ref[f"engines/{profile}/{mode}/tokens"] = np.array(tok.last, np.int64)
                # The weights the JAX engine serves: stacked and fused (the
                # port's Mllama engine fuses its own).
                served = (engine.vlm_params if profile == "qwen" else
                          engine.text_params if profile == "llama" else raw["mllama"])
                flatten_params(served, f"engines/{profile}/params", inp)
        finally:
            mp.undo()
            get_config(reload=True)


def _chat_config():
    from vis_tpu.models.common.decoder import DecoderConfig

    return DecoderConfig(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=4,
                         num_kv_heads=2, intermediate_size=128, qkv_bias=False,
                         tie_word_embeddings=False, dtype=jnp.float32)


def _chat_side(inp, ref):
    """Two turns on one session, with the tokenizer's EOS and with an EOS
    the first reply emits inside its first chunk."""
    config = _chat_config()
    params = _random_leaves(init_decoder_params(config, jax.random.PRNGKey(13)),
                            np.random.default_rng(13))
    with pytest.MonkeyPatch.context() as mp:
        try:
            _settings_env(mp, CHUNK)
            tok = recording_tokenizer(VOCAB)
            engine = Engine("chat", config, params, tok, max_cache_tokens=512)
            for kind in CHAT_KINDS:
                if kind == "eos":
                    first = ref["chat/plain/turn0/tokens"].tolist()
                    at = next(j for j in range(2, CHUNK) if first[j] not in first[:j])
                    # (a token not emitted before it, so the reply stops there)
                    tok.eos_id = first[at]
                    inp["chat/eos"] = np.array(first[at])
                session = engine.chat_start(CHAT_SYSTEM)
                for turn, question in enumerate(CHAT_TURNS):
                    text = "".join(engine.chat_turn(session, question, max_tokens=CHAT_TOKENS))
                    key = f"chat/{kind}/turn{turn}"
                    ref[f"{key}/text"] = text
                    ref[f"{key}/tokens"] = np.array(tok.last, np.int64)
                    ref[f"{key}/state"] = np.array([session.position,
                                                    int(np.asarray(session.cache.lengths)[0])])
            flatten_params(engine.text_params, "chat/params", inp)
        finally:
            mp.undo()
            get_config(reload=True)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_decode_paths")
    inp, ref = {}, {}
    _loops_side(inp, ref)
    image = _image(tmp / "part.png", 64, 80, 5)
    _engines_side(inp, ref, image)
    _chat_side(inp, ref)
    inp.update({"vocab": np.array(VOCAB), "chat/system": np.array(CHAT_SYSTEM),
                "chat/turns": np.array(json.dumps(CHAT_TURNS)),
                "chat/config": np.array(decoder_json(_chat_config())),
                "settings": np.array([MAX_CACHE, CHAT_TOKENS, MAX_IMAGE_DIM]),
                "prompt": np.array(PROMPT)})
    port = run_port("decode_paths", inp, tmp)
    return ref, port


def _loop_case(profile, variant, mode):
    return f"loops/{profile}/{variant}/{mode}"


@pytest.mark.parametrize("mode", LOOP_MODES + EXIT_MODES)
@pytest.mark.parametrize("profile", LOOP_PROFILES)
def test_f32_loop_tokens_equal(sides, profile, mode):
    ref, port = sides
    key = _loop_case(profile, "f32", mode)
    want, got = ref[f"{key}/tokens"], port[f"{key}/tokens"]
    mismatch = np.argwhere(want != got)
    assert mismatch.size == 0, f"first differing (row, step): {mismatch[0].tolist()}"
    np.testing.assert_array_equal(port[f"{key}/lengths"], ref[f"{key}/lengths"])
    np.testing.assert_array_equal(port[f"{key}/lengths_host"], ref[f"{key}/lengths"])
    np.testing.assert_allclose(port[f"{key}/logits"], ref[f"{key}/logits"], atol=3e-4, rtol=0)
    if mode.startswith("constrained"):
        np.testing.assert_array_equal(port[f"{key}/state"], ref[f"{key}/state"])


@pytest.mark.parametrize("profile", LOOP_PROFILES)
def test_loop_exits(sides, profile):
    """EOS: row 0 stops at its EOS inside the 12-step chunk, row 1 (budget
    0) reads EOS throughout, and the loop ends right after the EOS step
    (both cursors advanced by the steps run).  Budget: rows 0 and 1 stop
    recording after 3 and 7 tokens, and the loop runs 7 steps."""
    ref, _ = sides
    eos = ref[_loop_case(profile, "f32", "eos") + "/tokens"]
    stop = int(np.argmax(eos[0] == eos[0, 4]))
    assert 0 < stop <= 4 and (eos[0, stop:] == eos[0, stop]).all()
    assert (eos[1] == eos[0, stop]).all()
    lengths = ref[_loop_case(profile, "f32", "eos") + "/lengths"]
    assert lengths.tolist() == [n + stop + 1 for n in PROMPTS]
    greedy = ref[_loop_case(profile, "f32", "greedy") + "/tokens"]
    np.testing.assert_array_equal(eos[0, :stop], greedy[0, :stop])
    budget = ref[_loop_case(profile, "f32", "budget") + "/tokens"]
    assert (budget[0, 3:] == EOS_NEVER).all() and (budget[1, 7:] == EOS_NEVER).all()
    np.testing.assert_array_equal(budget[1, :7], greedy[1, :7])
    lengths = ref[_loop_case(profile, "f32", "budget") + "/lengths"]
    assert lengths.tolist() == [n + 7 for n in PROMPTS]


@pytest.mark.parametrize("mode", LOOP_MODES)
@pytest.mark.parametrize("variant", ("int4", "int8"))
@pytest.mark.parametrize("profile", LOOP_PROFILES)
def test_quantized_loop_first_step(sides, profile, variant, mode):
    ref, port = sides
    key = _loop_case(profile, variant, mode)
    want, got = ref[f"{key}/logits"], port[f"{key}/logits"]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2.0 ** -6 * np.abs(want).max(), rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_array_equal(port[f"{key}/tokens"], ref[f"{key}/tokens"])
    np.testing.assert_array_equal(port[f"{key}/lengths_host"], ref[f"{key}/lengths"])


ENGINE_CASES = [(profile, mode) for profile, modes in ENGINES.items() for mode in modes
                if profile != "mllama"]


@pytest.mark.parametrize("profile,mode", ENGINE_CASES)
def test_engine_tokens_equal(sides, profile, mode):
    ref, port = sides
    key = f"engines/{profile}/{mode}"
    assert port[f"{key}/tokens"].tolist() == ref[f"{key}/tokens"].tolist()
    assert str(port[f"{key}/text"]) == ref[f"{key}/text"]
    kwargs = ENGINE_MODES[mode][2]
    if kwargs.get("json_mode"):
        doc = json.loads(ref[f"{key}/text"])
        assert list(doc) == [k for k, _ in SCHEMAS["inspection"].props]
    chunk = ENGINE_MODES[mode][1]
    if chunk < kwargs["max_tokens"]:  # the request chained chunks
        assert len(ref[f"{key}/tokens"]) > chunk


@pytest.mark.parametrize("mode", ENGINES["mllama"] + tuple(MLLAMA_ALIASES))
def test_mllama_engine_tokens_equal(sides, mode):
    """The Mllama loop engine in every mode; ``sampled_free`` and
    ``no_window`` (schema-constrained with CONSTRAINED_LOOKAHEAD=0) are the
    requests it refused before, now decoded as the reference decodes them."""
    ref, port = sides
    key = f"engines/mllama/{MLLAMA_ALIASES.get(mode, mode)}"
    assert port[f"{key}/tokens"].tolist() == ref[f"{key}/tokens"].tolist()
    assert str(port[f"{key}/text"]) == ref[f"{key}/text"]
    assert len(ref[f"{key}/tokens"]) > 0


@pytest.mark.parametrize("profile", ("llama", "mllama"))
def test_health_check_goes_through_the_fused_loop(sides, profile):
    _, port = sides
    assert port[f"health/{profile}"].tolist() == [1, 2]


@pytest.mark.parametrize("kind", CHAT_KINDS)
@pytest.mark.parametrize("turn", range(len(CHAT_TURNS)))
def test_chat_turns_equal(sides, kind, turn):
    ref, port = sides
    key = f"chat/{kind}/turn{turn}"
    assert port[f"{key}/tokens"].tolist() == ref[f"{key}/tokens"].tolist()
    assert str(port[f"{key}/text"]) == ref[f"{key}/text"]
    np.testing.assert_array_equal(port[f"{key}/state"], ref[f"{key}/state"])


def test_chat_eos_rewinds_the_cursor(sides):
    """The first reply ends on EOS inside its first chunk: its tokens stop
    there and the cursor sits right after the last kept token."""
    ref, _ = sides
    plain, eos = ref["chat/plain/turn0/tokens"], ref["chat/eos/turn0/tokens"]
    assert 2 <= len(eos) < CHUNK and eos.tolist() == plain[:len(eos)].tolist()
    position, cursor = ref["chat/eos/turn0/state"].tolist()
    plain_position, plain_cursor = ref["chat/plain/turn0/state"].tolist()
    assert plain_position - position == plain_cursor - cursor == len(plain) - len(eos)


def test_chat_follow_up_equals_reprefill(sides):
    """The second turn's reply equals a greedy decode of the whole
    transcript's ids prefilled from scratch."""
    _, port = sides
    assert port["chat/reprefill"].tolist() == port["chat/plain/turn1/tokens"].tolist()


def test_chat_budget_raises(sides):
    _, port = sides
    assert "KV budget exhausted" in str(port["chat/budget"])


def test_chat_counts_decode_tokens(sides):
    ref, port = sides
    last, total = port["chat/counts"].tolist()
    turns = [len(ref[f"chat/plain/turn{t}/tokens"]) for t in range(len(CHAT_TURNS))]
    assert last == turns[-1] and total == sum(turns)


# -- the pipeline under the config's default decode settings ---------------

# The explainer stays on the mock provider: nothing compared reads it, its
# free-form sampled decode is the engines' case above, and the prefill of
# its ~2k-token prompts takes a minute on this CPU.
PIPELINE_ENV = {
    "DEV_PROFILE": "small", "USE_MOCK_RESPONSES": "false", "EXPLAINER_PROVIDER": "mock",
    "VLM_INSPECTOR_MAX_TOKENS": "8", "VLM_AUDITOR_MAX_TOKENS": "8",
    "EXPLAINER_MAX_TOKENS": "8", "MAX_IMAGE_DIMENSION": "224",
    "AUDITOR_MAX_IMAGE_DIMENSION": "224", "LOG_TO_FILE": "false",
}
# Decode settings left at the config's defaults (free-form sampled decode,
# no lookahead, no batching, host preprocess).
DEFAULTED = ("CONSTRAINED_JSON", "CONSTRAINED_SCHEMA", "CONSTRAINED_LOOKAHEAD",
             "CONSTRAINED_JSON_MIN_TOKENS", "CONTINUOUS_BATCHING", "DECODE_CHUNK",
             "DEVICE_PREPROCESS", "QUANTIZATION", "VOCAB_QUANTIZATION", "KV_QUANTIZATION",
             "SPECULATIVE_DECODING", "PREFIX_CACHING", "KV_CACHE_MAX_TOKENS",
             "VLM_INSPECTOR_TEMPERATURE", "VLM_AUDITOR_TEMPERATURE", "EXPLAINER_TEMPERATURE",
             "VLM_INSPECTOR_MIN_TOKENS", "VLM_AUDITOR_MIN_TOKENS", "CHECKPOINT_DIR")

_JAX_PIPELINE = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
from vis_tpu.orchestration.graph import run_inspection
state = run_inspection(sys.argv[2], criticality="high", domain="general",
                       user_notes="default decode")
print("RESULT::" + json.dumps({
    "verdict": (state.get("safety_verdict") or {}).get("verdict"),
    "inspector_failed": state["inspector_result"]["analysis_failed"],
    "auditor_failed": state["auditor_result"]["analysis_failed"],
}))
"""


def _pipeline_env(workdir: Path, overrides: dict) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in DEFAULTED}
    env.update(PIPELINE_ENV, CHECKPOINT_DIR=str(workdir / "no_checkpoints"),
               DATABASE_PATH=str(workdir / "inspections.db"),
               CHAT_HISTORY_DB=str(workdir / "chat.db"), UPLOAD_DIR=str(workdir / "uploads"),
               REPORT_DIR=str(workdir / "reports"), LOG_DIR=str(workdir / "logs"), **overrides)
    return env


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """The JAX package's run_inspection (a subprocess, providers "tpu")
    beside the port's (providers "cuda", TORCH_DEVICE=cpu), on one image."""
    tmp = tmp_path_factory.mktemp("torch_decode_pipeline")
    image = _image(tmp / "part.jpg", 96, 128, 6)
    jax_dir, port_dir = tmp / "jax", tmp / "port"
    env = _pipeline_env(jax_dir, {"JAX_PLATFORMS": "cpu", "VLM_INSPECTOR_PROVIDER": "tpu",
                                  "VLM_AUDITOR_PROVIDER": "tpu"})
    jax_run = subprocess.Popen([sys.executable, "-c", _JAX_PIPELINE, str(REPO), image],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                               env=env, cwd=str(REPO))
    port_env = _pipeline_env(port_dir, {"VLM_INSPECTOR_PROVIDER": "cuda",
                                        "VLM_AUDITOR_PROVIDER": "cuda", "TORCH_DEVICE": "cpu"})
    port = run_port("decode_pipeline", {"image": np.array(image),
                                        "env": np.array(json.dumps(port_env))}, tmp)
    out, err = jax_run.communicate(timeout=900)
    assert jax_run.returncode == 0, err[-3000:]
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT::"))
    return json.loads(line[len("RESULT::"):]), json.loads(str(port["result"]))


@pytest.mark.parametrize("field", ("verdict", "inspector_failed", "auditor_failed"))
def test_pipeline_default_decode_matches_jax(pipeline, field):
    ref, port = pipeline
    assert port[field] == ref[field]


def test_pipeline_default_decode_raised_nothing(pipeline):
    """Every role's backend calls returned text: no NotImplementedError (or
    any other exception) from an engine, and each role decoded tokens."""
    _, port = pipeline
    assert port["errors"] == []
    assert set(port["calls"]) == {"inspector", "auditor"}
    assert all(n > 0 for n in port["tokens"].values()), port["tokens"]
