"""The port's Llama decoder and paged decode against the JAX package, on
the tiny Llama config (llama_tiny, vocab widened to the byte tokenizer's 512
ids) with the explainer's layout: int4 stacked and fused layers, int8
embedding and vocab head (rows padded to 512).  Weights are made on the
JAX side and carried over with ``from_jax_numpy``.

- Prefill logits and one 8-slot extend chunk (6 valid tokens) against
  ``prefill_scan`` and ``extend_scan``.  The int8 embedding hands the stack
  bf16 activations, and both int matmuls round their input to bf16, so a
  last-bit f32 difference upstream (a sum in another order) can flip a bf16
  rounding that later layers carry: logits are held to max|err| <= 2^-6 *
  max|ref| (bf16 keeps 8 significant bits), with the argmax equal.
- ``decode_loop_paged_constrained`` (float embedding here, see below) on
  the same pool, page tables, lengths
  and stacked tables (generic JSON, inspection, decision_support): slot 0
  free-form, slot 1 generic JSON with a length floor, slot 2 the
  decision_support schema, slot 3 inactive.  Greedy; sampled with the JAX
  side's per-step uniforms replayed into the port (slot 1 greedy inside
  the sampled batch); a chunk that exits on EOS: a JSON row closes and
  emits EOS inside its 30-step budget, after a free-form row spent its
  budget of 3; the same greedy batch over column-compressed tables (a
  [T, V] class map, one never-allowed column for the ids past the byte
  table), which must give the dense tables' tokens; and
  ``decode_loop_paged`` with no grammar at all.  Tokens, cursors and DFA states are exactly equal; the
  final pool (page 0, the trash page, excluded) is held to the logits'
  bound, 2^-6 * max|ref|, for the same reason.

The decode runs keep the embedding table float: an int8 embedding puts the
whole residual stream in bf16, where sums taken in another order round to
other bf16 values now and then, and a free-form greedy row then flips a
near-tie within a few steps (measured: step 9).  The int8 embedding gather
is compared bit-exactly in test_torch_int8.py and runs in the logits
comparison above.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vis_tpu.models.common.decoder import (
    DecodeConstraint,
    decode_loop_paged,
    decode_loop_paged_constrained,
    extend_scan,
    fuse_stacked_projections,
    init_decoder_params,
    prefill_scan,
    quantize_stacked_params,
    stack_decoder_layers,
)
from vis_tpu.models.common.layers import KVCache, embed
from vis_tpu.models.llama.config import llama_tiny
from vis_tpu.serving.constrained import json_constraint_tables
from vis_tpu.serving.schema import schema_constraint_tables
from vis_tpu.serving.tokenizer import ByteTokenizer
from torch_port import flatten_params, run_port

OVERRIDES = {"vocab_size": 512}
SEQ_LEN, S_PAD, MAX_LEN, N_NEW = 37, 48, 128, 6
PAGE, N_PAGES, SLOTS, MAX_PAGES, STAGING = 16, 16, 4, 8, 48
PROMPTS = (21, 34, 40)  # prompt lengths of slots 0..2; slot 3 is inactive
EOS = 256
TABLES = (None, "inspection", "decision_support")
MODES = ("greedy", "sampled", "eos", "free", "compressed")


def tiny_llama():
    return dataclasses.replace(llama_tiny(), **OVERRIDES)


def carried_params(config, seed, int8_embedding=True):
    """The explainer layout of a random tiny Llama: norms near 1, int4
    layers, int8 vocab head, and an int8 embedding (or the float one)."""
    rng = np.random.default_rng(seed)
    params = init_decoder_params(config, jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(1.0 + 0.1 * rng.standard_normal(leaf.shape),
                                       leaf.dtype)
        if "norm" in jax.tree_util.keystr(path) else leaf, params)
    stacked = fuse_stacked_projections(stack_decoder_layers(params))
    out = quantize_stacked_params(stacked, quantize_embeddings=True, mode="int4",
                                  vocab_mode="int8")
    if not int8_embedding:
        out["embed_tokens"] = stacked["embed_tokens"]
    return out


def stacked_tables(tokenizer, vocab):
    """The JAX scheduler's stacking of TABLES: [T, S_max, K_max], padded
    entries unreachable."""
    found = [json_constraint_tables(tokenizer, vocab) if name is None
             else schema_constraint_tables(tokenizer, vocab, name) for name in TABLES]
    smax = max(t.token_ok.shape[0] for t in found)
    kmax = max(t.token_ok.shape[1] for t in found)

    def stack(field, fill=0):
        return np.stack([np.pad(getattr(t, field), ((0, smax - t.token_ok.shape[0]),
                                                     (0, kmax - t.token_ok.shape[1])),
                                constant_values=fill) for t in found])

    return found, stack("token_ok"), stack("token_trans"), stack("cost_after", 2**30)


def _mode_rows(mode, found):
    """Per-slot constraint rows, chunk budget, steps and temperatures."""
    generic, _, decision = found
    if mode == "eos":  # slot 1 closes its JSON and ends on EOS, slot 2 on budget
        return dict(state=[0, generic.init_state, 0, 0],
                    remaining=[1, 10, 48, 1], active=[False, True, False, False],
                    min_remaining=[0, 10, 48, 0], table_idx=[0, 0, 0, 0],
                    budget=[0, 30, 3, 0], steps=30)
    return dict(state=[0, generic.init_state, decision.init_state, 0],
                remaining=[48, 64, 200, 1], active=[False, True, True, False],
                min_remaining=[48, 54, 200, 0], table_idx=[0, 0, 2, 0],
                budget=[20, 24, 24, 0], steps=24)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    config = tiny_llama()
    params = carried_params(config, 3)
    decode_params = carried_params(config, 3, int8_embedding=False)
    rng = np.random.default_rng(5)
    inp = flatten_params(params, "params", {})
    flatten_params(decode_params, "decode_params", inp)
    inp["config"] = np.array(json.dumps(OVERRIDES))
    ref = {}

    ids = np.zeros((1, S_PAD), np.int64)
    ids[0, :SEQ_LEN] = rng.integers(10, 256, SEQ_LEN)
    chunk = np.zeros((1, 8), np.int64)
    chunk[0, :N_NEW] = rng.integers(10, 256, N_NEW)
    inp.update({"prefill/ids": ids, "extend/ids": chunk,
                "prefill_dims": np.array([SEQ_LEN, S_PAD, MAX_LEN, N_NEW])})
    table = params["embed_tokens"]
    cache = KVCache.create(config.num_layers, 1, MAX_LEN, config.num_kv_heads,
                           config.head_dim_, dtype=config.dtype)
    logits, cache = prefill_scan(config, params, embed(jnp.asarray(ids), table),
                                 jnp.arange(S_PAD, dtype=jnp.int32)[None], cache,
                                 jnp.asarray([SEQ_LEN]))
    ref["prefill"] = np.asarray(logits)
    logits, _ = extend_scan(config, params, embed(jnp.asarray(chunk), table),
                            jnp.arange(SEQ_LEN, SEQ_LEN + 8, dtype=jnp.int32)[None], cache,
                            jnp.asarray([N_NEW]))
    ref["extend"] = np.asarray(logits)

    # A paged pool holding three prefilled prompts, 5 pages a slot.
    params, table = decode_params, decode_params["embed_tokens"]
    kvh, hd, L = config.num_kv_heads, config.head_dim_, config.num_layers
    pool_k = np.zeros((L, N_PAGES, PAGE, kvh, hd), np.float32)
    pool_v = np.zeros_like(pool_k)
    tables = np.zeros((SLOTS, MAX_PAGES), np.int32)
    first = np.zeros((SLOTS, config.vocab_size), np.float32)
    for slot, plen in enumerate(PROMPTS):
        tables[slot, :5] = 1 + 5 * slot + np.arange(5)
        prompt = np.zeros((1, STAGING), np.int64)
        prompt[0, :plen] = rng.integers(10, 256, plen)
        staging = KVCache.create(L, 1, STAGING, kvh, hd, dtype=config.dtype)
        logits, staging = prefill_scan(config, params, embed(jnp.asarray(prompt), table),
                                       jnp.arange(STAGING, dtype=jnp.int32)[None], staging,
                                       jnp.asarray([plen]))
        pages = tables[slot, :STAGING // PAGE]
        pool_k[:, pages] = np.asarray(staging.k[:, 0]).reshape(L, -1, PAGE, kvh, hd)
        pool_v[:, pages] = np.asarray(staging.v[:, 0]).reshape(L, -1, PAGE, kvh, hd)
        first[slot] = np.asarray(logits[0])
    inp.update({"pool/k": pool_k, "pool/v": pool_v, "page_tables": tables,
                "eos": np.array(EOS), "modes": np.array(json.dumps(MODES))})

    found, ok, trans, cost = stacked_tables(ByteTokenizer(vocab_size=config.vocab_size),
                                            config.vocab_size)
    inp.update({"tables/token_ok": ok, "tables/token_trans": trans, "tables/cost_after": cost})
    k = ok.shape[-1]
    compressed = {  # one extra column, never allowed, for every id >= k
        "token_ok": np.pad(ok, ((0, 0), (0, 0), (0, 1))),
        "token_trans": np.pad(trans, ((0, 0), (0, 0), (0, 1))),
        "cost_after": np.pad(cost, ((0, 0), (0, 0), (0, 1)), constant_values=2**30),
        "class_of": np.tile(np.minimum(np.arange(config.vocab_size), k), (len(TABLES), 1)),
    }
    inp.update({f"tables_cls/{name}": a for name, a in compressed.items()})
    lengths = np.array(list(PROMPTS) + [0], np.int32)
    for mode in MODES:
        rows = _mode_rows(mode, found)
        live = np.array(rows["budget"]) > 0
        start = np.where(live, lengths, 0).astype(np.int32)
        inp.update({f"{mode}/{k}": np.array(rows[k]) for k in
                    ("state", "remaining", "active", "min_remaining", "table_idx", "budget")})
        inp.update({f"{mode}/steps": np.array(rows["steps"]), f"{mode}/start": start,
                    f"{mode}/lengths": start, f"{mode}/logits": first})
        if mode == "free":
            tokens, _, pk, pv, out_len = decode_loop_paged(
                config, params, jnp.asarray(first), jnp.asarray(start), jnp.asarray(pool_k),
                jnp.asarray(pool_v), jnp.asarray(tables), jnp.asarray(start), rows["steps"],
                eos_id=EOS, budget=jnp.asarray(rows["budget"], jnp.int32))
            ref.update({f"{mode}/tokens": np.asarray(tokens),
                        f"{mode}/lengths": np.asarray(out_len),
                        f"{mode}/pool_k": np.asarray(pk), f"{mode}/pool_v": np.asarray(pv)})
            continue
        grammar = compressed if mode == "compressed" else {
            "token_ok": ok, "token_trans": trans, "cost_after": cost, "class_of": None}
        constraint = DecodeConstraint(
            token_ok=jnp.asarray(grammar["token_ok"]),
            token_trans=jnp.asarray(grammar["token_trans"]),
            cost_after=jnp.asarray(grammar["cost_after"]),
            class_of=None if grammar["class_of"] is None else jnp.asarray(grammar["class_of"]),
            state=jnp.asarray(rows["state"], jnp.int32),
            remaining=jnp.asarray(rows["remaining"], jnp.int32),
            active=jnp.asarray(rows["active"]),
            min_remaining=jnp.asarray(rows["min_remaining"], jnp.int32),
            table_idx=jnp.asarray(rows["table_idx"], jnp.int32),
        )
        kwargs = {}
        if mode == "sampled":
            key, temps = jax.random.PRNGKey(11), np.array([0.7, 0.0, 0.5, 0.0], np.float32)
            uniforms, rng_key = [], key
            for _ in range(rows["steps"]):
                rng_key, sub = jax.random.split(rng_key)
                uniforms.append(np.asarray(jax.random.uniform(
                    sub, (SLOTS, config.vocab_size), jnp.float32, 1e-20, 1.0)))
            inp[f"{mode}/uniforms"], inp[f"{mode}/temperature"] = np.stack(uniforms), temps
            kwargs = dict(key=key, temperature=jnp.asarray(temps))
        tokens, _, pk, pv, out_len, con = decode_loop_paged_constrained(
            config, params, jnp.asarray(first), jnp.asarray(start), jnp.asarray(pool_k),
            jnp.asarray(pool_v), jnp.asarray(tables), jnp.asarray(start), constraint,
            rows["steps"], eos_id=EOS, budget=jnp.asarray(rows["budget"], jnp.int32),
            **kwargs)
        ref.update({f"{mode}/tokens": np.asarray(tokens), f"{mode}/lengths": np.asarray(out_len),
                    f"{mode}/state": np.asarray(con.state), f"{mode}/pool_k": np.asarray(pk),
                    f"{mode}/pool_v": np.asarray(pv)})
    port = run_port("llama", inp, tmp_path_factory.mktemp("torch_llama"))
    return ref, port


@pytest.mark.parametrize("name", ["prefill", "extend"])
def test_llama_logits_match_jax(sides, name):
    ref, port = sides
    want, got = ref[name], port[name]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2.0 ** -6 * np.abs(want).max(), rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("mode", MODES)
def test_paged_constrained_decode_tokens_equal(sides, mode):
    ref, port = sides
    want, got = ref[f"{mode}/tokens"], port[f"{mode}/tokens"]
    mismatch = np.argwhere(want != got)
    assert mismatch.size == 0, f"first differing (slot, step): {mismatch[0].tolist()}"
    np.testing.assert_array_equal(port[f"{mode}/lengths"], ref[f"{mode}/lengths"])
    if mode != "free":
        np.testing.assert_array_equal(port[f"{mode}/state"], ref[f"{mode}/state"])
    assert (want[3] == EOS).all()  # the inactive slot only ever reads EOS
    if mode == "compressed":  # the class map changes nothing but the table layout
        np.testing.assert_array_equal(want, ref["greedy/tokens"])


def test_paged_decode_exits(sides):
    """Budget exit: the chunk runs the longest live budget (24 steps) and
    slot 0 stops at its own 20.  EOS exit: slot 1 closes its document and
    emits EOS well inside its 30-step budget, slot 2 stops at its budget of
    3, and the loop stops right after the EOS."""
    ref, _ = sides
    greedy = ref["greedy/tokens"]
    assert (greedy[0, 20:] == EOS).all() and (greedy[0, :20] != EOS).all()
    eos = ref["eos/tokens"]
    closed = int(np.argmax(eos[1] == EOS))
    assert 3 <= closed < 29 and (eos[1, closed:] == EOS).all(), eos[1]
    assert (eos[2, :3] != EOS).all() and (eos[2, 3:] == EOS).all()
    assert int(ref["eos/lengths"][1]) - PROMPTS[1] == closed + 1


@pytest.mark.parametrize("mode", MODES)
def test_paged_decode_final_pool(sides, mode):
    ref, port = sides
    for name in ("pool_k", "pool_v"):
        want, got = ref[f"{mode}/{name}"][:, 1:], port[f"{mode}/{name}"][:, 1:]
        np.testing.assert_allclose(got, want, atol=2.0 ** -6 * np.abs(want).max(), rtol=0)
