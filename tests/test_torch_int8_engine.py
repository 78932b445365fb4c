"""The port's QUANTIZATION=int8 path against the JAX package's, with the JAX
side forced onto its Pallas kernel bodies (interpret mode with
``jax.default_backend`` patched to "tpu", as test_torch_int8.py does): off
the TPU the JAX package takes neither its int8 matmul kernel nor its fused
MLP kernel, and its CPU fallback rounds each dequantized weight to bf16,
which is not the kernels' function.  The port side runs on the CPU in a
subprocess, where every kernel wrapper takes its plain version.

- Kernel E (``fused_swiglu_mlp``) through ``swiglu_mlp`` at the small
  profile's MLP (hidden 1024, inter 2816: eleven 256-wide blocks on the
  TPU) at rows 1, 3 and 8, and at two inputs the dispatch rule refuses
  (inter 200, where no block divides; 130 rows), where both sides take the
  unfused path.  x is f32, so the output is f32.  The two sides differ in
  the order of their f32 sums, and a last-bit difference in g or u can
  move h = bf16(silu(g) * u) across a bf16 rounding boundary; one such
  flip changes y by at most ulp(h_i) * |w_oi|.  Bound: max|err| <= 2^-12 *
  max_o sum_i |h_i w_oi| + 1e-5 * max|y|, a flip of one in sixteen h
  values at their largest weights.
- ``quantize_stacked_params(mode="int8")``: every byte of every q and
  scale, vocab tables included, equals the JAX package's.
- The int8 ``_pick_layer``: a QuantizedWeight of contiguous views of the
  stack (no copy).
- The small Qwen2.5-VL text stack (M-RoPE, qkv bias, tied int8 vocab) and
  the small Llama text profile at int8 (int8 layers, int8 embedding and
  vocab head): prefill logits; for Qwen one 8-token lookahead window under
  the inspection schema; for Llama one 4-step paged scheduler chunk over
  three slots (free-form, generic JSON, decision_support).  Both stacks
  are bf16, so a sum taken in another order can flip a bf16 rounding that
  later layers carry: logits are held to max|err| <= 2^-5 * max|ref|, and
  the tokens must be equal.  The int8 embedding stays in: at these
  lengths the streams are token-exact with it.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vis_tpu.models.common.decoder import (
    DecodeConstraint,
    DecoderConfig,
    decode_loop_lookahead,
    decode_loop_paged_constrained,
    fuse_stacked_projections,
    init_decoder_params,
    prefill_scan,
    quantize_stacked_params,
    stack_decoder_layers,
)
from vis_tpu.models.common.layers import KVCache, embed, swiglu_mlp
from vis_tpu.ops.quantized import QuantizedWeight, fused_swiglu_mlp, quantize_weight
from vis_tpu.serving.constrained import json_constraint_tables
from vis_tpu.serving.engine import _dev_text_config
from vis_tpu.serving.schema import schema_constraint_tables
from vis_tpu.serving.tokenizer import ByteTokenizer
from torch_port import run_port

HIDDEN, INTER = 1024, 2816
MLP_CASES = {"rows1": (1, INTER), "rows3": (3, INTER), "rows8": (8, INTER),
             "inter200": (8, 200), "rows130": (130, INTER)}
FUSED = {"rows1", "rows3", "rows8"}
PROFILES = ("qwen", "llama")
SEQ_LEN, S_PAD, MAX_LEN, WINDOW, EOS = 40, 64, 128, 8, 256
PAGE, MAX_PAGES, PROMPTS, STAGING, STEPS = 16, 4, (21, 34, 40), 48, 4
TABLES = (None, "inspection", "decision_support")


def _interpret(fn, *args, **kwargs):
    """Run ``fn`` with the JAX package on its Pallas kernel bodies."""
    with pltpu.force_tpu_interpret_mode():
        orig = jax.default_backend
        try:
            jax.default_backend = lambda: "tpu"
            return fn(*args, **kwargs)
        finally:
            jax.default_backend = orig


def qwen_small_text() -> DecoderConfig:
    """The JAX package's small Qwen2.5-VL profile's text stack."""
    return DecoderConfig(
        vocab_size=1024, hidden_size=1024, num_layers=8, num_heads=8, num_kv_heads=2,
        intermediate_size=2816, rope_theta=1_000_000.0, qkv_bias=True,
        mrope_section=(16, 24, 24), tie_word_embeddings=True)


def _flatten(tree, prefix, out):
    """"/"-joined paths -> numpy; floats as f32 (bf16 values exactly)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, QuantizedWeight):
        out[f"{prefix}/q"], out[f"{prefix}/scale"] = np.asarray(tree.q), np.asarray(tree.scale)
    else:
        a = np.asarray(tree)
        out[prefix] = a.astype(np.float32) if a.dtype.kind == "V" or "bfloat16" in str(a.dtype) \
            else a
    return out


def _random_stack(config, seed):
    """init_decoder_params' tree with random norms (near 1) and biases,
    stacked and fused: the float layout both quantizations start from."""
    rng = np.random.default_rng(seed)
    params = init_decoder_params(config, jax.random.PRNGKey(seed))

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if "norm" in name:
            return jnp.asarray(1.0 + 0.1 * noise, leaf.dtype)
        if "bias" in name:
            return jnp.asarray(0.02 * noise, leaf.dtype)
        return leaf

    params = jax.tree_util.tree_map_with_path(fill, params)
    return fuse_stacked_projections(stack_decoder_layers(params))


def _mlp_side(rng, inp, ref):
    for name, (rows, inter) in MLP_CASES.items():
        gate = 0.05 * rng.standard_normal((inter, HIDDEN)).astype(np.float32)
        up = 0.05 * rng.standard_normal((inter, HIDDEN)).astype(np.float32)
        down = 0.05 * rng.standard_normal((HIDDEN, inter)).astype(np.float32)
        x = rng.standard_normal((rows, HIDDEN)).astype(np.float32)
        gateup = quantize_weight(jnp.asarray(np.concatenate([gate, up])))
        dq = quantize_weight(jnp.asarray(down))
        params = {"gateup_proj": gateup, "down_proj": dq}
        fused = _interpret(fused_swiglu_mlp, jnp.asarray(x), gateup, dq)
        ref[f"mlp/{name}/fused"] = fused is not None
        ref[f"mlp/{name}"] = np.asarray(_interpret(swiglu_mlp, jnp.asarray(x), params))
        # The bound's scale: sum_i |h_i w_oi| with h from the plain math.
        g = (np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
             @ np.asarray(gateup.q, np.float32).T) * np.asarray(gateup.scale)
        h = np.abs(g[:, :inter] / (1 + np.exp(-g[:, :inter])) * g[:, inter:])
        w = np.abs(np.asarray(dq.q, np.float32) * np.asarray(dq.scale)[:, None])
        ref[f"mlp/{name}/scale"] = (h @ w.T).max()
        inp.update({f"mlp/{name}/x": x, f"mlp/{name}/gateup_q": np.asarray(gateup.q),
                    f"mlp/{name}/gateup_scale": np.asarray(gateup.scale),
                    f"mlp/{name}/down_q": np.asarray(dq.q),
                    f"mlp/{name}/down_scale": np.asarray(dq.scale)})


def _found_tables(vocab):
    tok = ByteTokenizer(vocab_size=vocab)
    return [json_constraint_tables(tok, vocab) if name is None
            else schema_constraint_tables(tok, vocab, name) for name in TABLES]


def _qwen_side(config, params, rng, inp, ref):
    ids = np.zeros((1, S_PAD), np.int64)
    ids[0, :SEQ_LEN] = rng.integers(10, 256, SEQ_LEN)
    pos = np.broadcast_to(np.arange(S_PAD, dtype=np.int32), (3, 1, S_PAD)).copy()
    pos[:, 0, SEQ_LEN:] = SEQ_LEN - 1
    inp.update({"qwen/ids": ids, "qwen/positions": pos})
    cache = KVCache.create(config.num_layers, 1, MAX_LEN, config.num_kv_heads,
                           config.head_dim_, dtype=config.dtype)
    logits, cache = _interpret(prefill_scan, config, params,
                               embed(jnp.asarray(ids), params["embed_tokens"]),
                               jnp.asarray(pos), cache, jnp.asarray([SEQ_LEN]))
    ref["qwen/prefill"] = np.asarray(logits.astype(jnp.float32))
    tables = _found_tables(config.vocab_size)[1]
    for name in ("token_ok", "token_trans", "cost_after", "forced_token", "forced_state"):
        inp[f"qwen/tables/{name}"] = getattr(tables, name)
    con = dict(state=np.array([tables.init_state], np.int32), remaining=np.array([160], np.int32),
               active=np.array([True]), min_remaining=np.array([60], np.int32))
    inp.update({f"qwen/con/{k}": v for k, v in con.items()})
    constraint = DecodeConstraint(
        token_ok=jnp.asarray(tables.token_ok), token_trans=jnp.asarray(tables.token_trans),
        cost_after=jnp.asarray(tables.cost_after), **{k: jnp.asarray(v) for k, v in con.items()})
    tokens, valid, last, cache, _ = _interpret(
        decode_loop_lookahead, config, params, logits, jnp.int32(SEQ_LEN), cache, constraint,
        jnp.asarray(tables.forced_token), jnp.asarray(tables.forced_state),
        num_windows=1, window=WINDOW, eos_id=EOS)
    ref.update({"qwen/tokens": np.asarray(tokens), "qwen/valid": np.asarray(valid),
                "qwen/window": np.asarray(last.astype(jnp.float32)),
                "qwen/lengths": np.asarray(cache.lengths)})


def _llama_side(config, params, rng, inp, ref):
    kvh, hd, L = config.num_kv_heads, config.head_dim_, config.num_layers
    slots, n_pages = len(PROMPTS), 1 + MAX_PAGES * len(PROMPTS)
    pool_k = np.zeros((L, n_pages, PAGE, kvh, hd), np.float32)
    pool_v = np.zeros_like(pool_k)
    tables = np.zeros((slots, MAX_PAGES), np.int32)
    first = np.zeros((slots, config.vocab_size), np.float32)
    table = params["embed_tokens"]
    for slot, plen in enumerate(PROMPTS):
        tables[slot] = 1 + MAX_PAGES * slot + np.arange(MAX_PAGES)
        prompt = np.zeros((1, STAGING), np.int64)
        prompt[0, :plen] = rng.integers(10, 256, plen)
        inp[f"llama/prompt{slot}"] = prompt
        staging = KVCache.create(L, 1, STAGING, kvh, hd, dtype=config.dtype)
        logits, staging = _interpret(
            prefill_scan, config, params, embed(jnp.asarray(prompt), table),
            jnp.arange(STAGING, dtype=jnp.int32)[None], staging, jnp.asarray([plen]))
        pages = tables[slot, :STAGING // PAGE]
        pool_k[:, pages] = np.asarray(staging.k[:, 0].astype(jnp.float32)).reshape(
            L, -1, PAGE, kvh, hd)
        pool_v[:, pages] = np.asarray(staging.v[:, 0].astype(jnp.float32)).reshape(
            L, -1, PAGE, kvh, hd)
        first[slot] = np.asarray(logits[0].astype(jnp.float32))
    ref["llama/prefill"] = first.copy()
    found = _found_tables(config.vocab_size)
    smax = max(t.token_ok.shape[0] for t in found)
    kmax = max(t.token_ok.shape[1] for t in found)

    def stack(field, fill=0):
        return np.stack([np.pad(getattr(t, field), ((0, smax - t.token_ok.shape[0]),
                                                     (0, kmax - t.token_ok.shape[1])),
                                constant_values=fill) for t in found])

    grammar = {"token_ok": stack("token_ok"), "token_trans": stack("token_trans"),
               "cost_after": stack("cost_after", 2**30)}
    rows = dict(state=np.array([0, found[0].init_state, found[2].init_state], np.int32),
                remaining=np.array([48, 64, 200], np.int32),
                active=np.array([False, True, True]),
                min_remaining=np.array([48, 54, 200], np.int32),
                table_idx=np.array([0, 0, 2], np.int32))
    lengths = np.array(PROMPTS, np.int32)
    inp.update({"llama/pool_k": pool_k, "llama/pool_v": pool_v, "llama/page_tables": tables,
                "llama/first": first, "llama/lengths": lengths})
    inp.update({f"llama/tables/{k}": v for k, v in grammar.items()})
    inp.update({f"llama/con/{k}": v for k, v in rows.items()})
    constraint = DecodeConstraint(**{k: jnp.asarray(v) for k, v in grammar.items()},
                                  **{k: jnp.asarray(v) for k, v in rows.items()})
    tokens, last, _, _, out_len, con = _interpret(
        decode_loop_paged_constrained, config, params, jnp.asarray(first), jnp.asarray(lengths),
        jnp.asarray(pool_k, config.dtype), jnp.asarray(pool_v, config.dtype),
        jnp.asarray(tables), jnp.asarray(lengths), constraint, STEPS, eos_id=EOS,
        budget=jnp.full((slots,), STEPS, jnp.int32))
    ref.update({"llama/tokens": np.asarray(tokens), "llama/chunk": np.asarray(
        last.astype(jnp.float32)), "llama/lengths": np.asarray(out_len),
        "llama/state": np.asarray(con.state)})


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    rng = np.random.default_rng(17)
    inp, ref = {}, {}
    _mlp_side(rng, inp, ref)
    for profile, config in (("qwen", qwen_small_text()), ("llama", _dev_text_config())):
        stacked = _random_stack(config, 5 if profile == "qwen" else 6)
        params = quantize_stacked_params(stacked, quantize_embeddings=True, mode="int8")
        _flatten(stacked, f"{profile}/float", inp)
        _flatten(params, f"{profile}/jax_int8", ref)
        _flatten(params, f"{profile}/params", inp)
        (_qwen_side if profile == "qwen" else _llama_side)(config, params, rng, inp, ref)
    inp["decode_dims"] = np.array([SEQ_LEN, S_PAD, MAX_LEN, WINDOW, EOS, STEPS])
    inp["mlp_cases"] = np.array(json.dumps(list(MLP_CASES)))
    port = run_port("int8_engine", inp, tmp_path_factory.mktemp("torch_int8_engine"))
    return ref, port


@pytest.mark.parametrize("name", list(MLP_CASES))
def test_fused_mlp_matches_jax_kernel(sides, name):
    ref, port = sides
    assert bool(ref[f"mlp/{name}/fused"]) == (name in FUSED)
    assert bool(port[f"mlp/{name}/fused"]) == (name in FUSED)
    want, got = ref[f"mlp/{name}"], port[f"mlp/{name}"]
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got - want).max()
    bound = 2.0 ** -12 * ref[f"mlp/{name}/scale"] + 1e-5 * np.abs(want).max()
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("profile", PROFILES)
def test_quantize_stacked_int8_bytes_equal(sides, profile):
    ref, port = sides
    prefix = f"{profile}/jax_int8/"
    keys = sorted(k[len(prefix):] for k in ref if k.startswith(prefix))
    got = sorted(k[len(f"{profile}/int8/"):] for k in port if k.startswith(f"{profile}/int8/"))
    assert got == keys
    for key in keys:
        want, have = ref[prefix + key], port[f"{profile}/int8/{key}"]
        assert have.dtype == want.dtype and have.shape == want.shape, key
        assert have.tobytes() == want.tobytes(), key


def test_int8_pick_layer_is_a_view(sides):
    _, port = sides
    assert json.loads(str(port["pick"])) == {
        "type": "QuantizedWeight", "contiguous": True, "view": True, "equal": True}


@pytest.mark.parametrize("name", ["qwen/prefill", "qwen/window", "llama/prefill", "llama/chunk"])
def test_int8_logits_match_jax(sides, name):
    ref, port = sides
    want, got = ref[name], port[name]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2.0 ** -5 * np.abs(want).max(), rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("profile", PROFILES)
def test_int8_tokens_equal(sides, profile):
    ref, port = sides
    np.testing.assert_array_equal(port[f"{profile}/tokens"], ref[f"{profile}/tokens"])
    np.testing.assert_array_equal(port[f"{profile}/lengths"], ref[f"{profile}/lengths"])
    if profile == "qwen":
        np.testing.assert_array_equal(port["qwen/valid"], ref["qwen/valid"])
    else:
        np.testing.assert_array_equal(port["llama/state"], ref["llama/state"])


def test_int8_path_took_kernel_e(sides):
    """Every decoder MLP of these runs went through fused_swiglu_mlp (its
    plain version on the CPU): prefill (<= 64 rows), the window and the
    chunk are all inside the dispatch rule."""
    _, port = sides
    calls = json.loads(str(port["fused_calls"]))
    assert calls["qwen"] == 8 * 2 and calls["llama"] == 8 * (len(PROMPTS) + STEPS)
