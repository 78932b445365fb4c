"""The port's Qwen2.5-VL slice against the JAX package on Qwen25VLConfig.tiny()
in f32, once with plain weights and once with the engine's int4 layout
(int4 stacked layers and vocab tables, int4 vision projections).  Weights
are made on the JAX side and handed over as numpy (from_jax_numpy).

Compared: window_layout arrays and resize_weights matrices (exact), device
preprocess patches (atol 1e-5), vision tower output and prefill logits
(atol 1e-4 with plain weights), and the tokens of decode_loop_lookahead
under the inspection schema's DFA, window 8 over a 32-token horizon, greedy
and sampled at temperature 0.1 with the JAX side's Gumbel uniforms (exactly
equal).  Two more runs decode to the end of the document (EOS), so the
JSON-length floor and the budget mask are compared through the close.

With int4 weights both sides round every int4 matmul's input to bf16, and
the int4 embedding table makes the whole text stack run in bf16, so a
last-bit f32 difference upstream (a sum taken in another order) can flip
a bf16 rounding and the flip propagates.  Vision output and logits are
then held to a few bf16 ulps at the output's scale: max|err| <= 2^-6 *
max|ref| (bf16 keeps 8 significant bits).  The tokens stay exactly equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vis_tpu.models.common.decoder import (
    DecodeConstraint,
    decode_loop_lookahead,
    fuse_stacked_projections,
    prefill_scan,
    quantize_stacked_params,
    stack_decoder_layers,
)
from vis_tpu.models.common.layers import KVCache
from vis_tpu.models.qwen2_5_vl import Qwen25VLConfig, init_params, vision_forward_25, window_layout
from vis_tpu.models.qwen2_vl.model import embed_multimodal
from vis_tpu.ops.preprocess import build_mrope_positions, patch_bucket_for
from vis_tpu.ops.preprocess_device import preprocess_frame_device, resize_weights
from vis_tpu.ops.quantized import QuantizedWeight4
from vis_tpu.serving.engine import _quantize_vision_tree
from vis_tpu.serving.schema import schema_constraint_tables
from vis_tpu.serving.tokenizer import ByteTokenizer
from torch_port import run_port

LAYOUTS = [  # grid_h, grid_w, min_len, src_len, 7B vision config?
    (6, 6, 0, 0, 0),
    (6, 6, 96, 64, 0),
    (6, 10, 256, 256, 0),
    (4, 8, 0, 0, 0),
    (54, 74, 8192, 4096, 1),  # assets/sample.jpg under the 7B tower
]
RESIZES = [(768, 756, 0), (1024, 1036, 0), (96, 84, 0), (128, 140, 0), (300, 100, 1)]
LAYOUT_FIELDS = ("gather_patch", "valid", "inv_merged", "inv_patch", "cos", "sin")
VARIANTS = ("plain", "int4")
MODES = ("greedy", "sampled", "greedy_to_eos", "sampled_to_eos")
WINDOW, NUM_WINDOWS, MAX_LEN, EOS = 8, 4, 96, 256
# The *_to_eos modes decode until the document closes (up to EOS_WINDOWS
# windows), which takes the floor and the budget mask through the close.
EOS_WINDOWS, EOS_MAX_TOKENS, EOS_MIN_TOKENS = 160, 160, 150
MAX_TOKENS, MIN_TOKENS, TEMPERATURE = 160, 100, 0.1


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    elif isinstance(tree, QuantizedWeight4):
        out[f"{prefix}/q"], out[f"{prefix}/scale"] = np.asarray(tree.q), np.asarray(tree.scale)
    else:
        out[prefix] = np.asarray(tree)


def _random_params(config, rng):
    """init_params' tree with every leaf random (norms near 1, biases
    small), so biases and norms take part in the comparison."""
    params = init_params(config, jax.random.PRNGKey(0))
    paths, treedef = jax.tree_util.tree_flatten_with_path(params)
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


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    config = Qwen25VLConfig.tiny()
    rng = np.random.default_rng(3)
    inp, ref = {}, {}

    inp["layouts"] = np.array(LAYOUTS)
    big = Qwen25VLConfig.qwen2_5_vl_7b().vision
    for i, (gh, gw, min_len, src_len, is_big) in enumerate(LAYOUTS):
        layout = window_layout(big if is_big else config.vision, gh, gw, min_len, src_len)
        for field in LAYOUT_FIELDS:
            ref[f"layout{i}/{field}"] = getattr(layout, field)
        ref[f"layout{i}/sizes"] = np.array([layout.n_windows, layout.win_len])
    inp["resizes"] = np.array(RESIZES)
    for i, (src, dst, bilinear) in enumerate(RESIZES):
        ref[f"resize{i}"] = resize_weights(src, dst, "bilinear" if bilinear else "bicubic")

    frame = rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
    dst_h, dst_w = 84, 140
    inp["frame"], inp["dst"] = frame, np.array([dst_h, dst_w])
    patches = np.asarray(preprocess_frame_device(jnp.asarray(frame), dst_h, dst_w))
    ref["patches"] = patches

    grid_h, grid_w = dst_h // 14, dst_w // 14
    n_patches = grid_h * grid_w
    bucket = patch_bucket_for(n_patches)
    layout = window_layout(config.vision, grid_h, grid_w, min_len=bucket, src_len=bucket)
    inp["vision_layout"] = np.array([grid_h, grid_w, bucket, bucket, n_patches])
    padded = np.zeros((bucket, patches.shape[1]), np.float32)
    padded[:n_patches] = patches
    inp["vision_patches"] = padded

    n_tokens = n_patches // 4
    text = rng.integers(10, 256, 20).tolist()
    ids = [config.vision_start_token_id] + [config.image_token_id] * n_tokens + \
        [config.vision_end_token_id] + text
    mrope, next_pos = build_mrope_positions(1, grid_h, grid_w, len(text) + 1)
    seq_len, s_pad = len(ids), 48
    padded_ids = np.zeros((1, s_pad), np.int64)
    padded_ids[0, :seq_len] = ids
    positions = np.zeros((3, 1, s_pad), np.int32)
    positions[:, 0, :seq_len] = mrope
    positions[:, 0, seq_len:] = mrope.max()
    inp.update(ids=padded_ids, positions=positions, next_pos=np.array(next_pos))

    tables = schema_constraint_tables(ByteTokenizer(vocab_size=512), 512, "inspection")
    for name in ("token_ok", "token_trans", "cost_after", "forced_token", "forced_state"):
        inp[f"tables/{name}"] = getattr(tables, name)
    budgets = {}
    for mode in MODES:
        max_tokens, min_tokens, windows = (
            (EOS_MAX_TOKENS, EOS_MIN_TOKENS, EOS_WINDOWS) if mode.endswith("to_eos")
            else (MAX_TOKENS, MIN_TOKENS, NUM_WINDOWS))
        budgets[mode] = windows, dict(
            state=np.array([tables.init_state], np.int32),
            remaining=np.array([max_tokens], np.int32), active=np.array([True]),
            min_remaining=np.array([max_tokens - min_tokens], np.int32))
        inp.update({f"{mode}/con/{k}": v for k, v in budgets[mode][1].items()})
        inp[f"{mode}/windows"] = np.array(windows)
    max_len = MAX_LEN + EOS_MAX_TOKENS
    inp["decode_dims"] = np.array([seq_len, max_len, WINDOW, 0, EOS])
    key = jax.random.PRNGKey(7)
    uniforms, sub_rng = [], key
    for _ in range(EOS_WINDOWS):
        sub_rng, sub = jax.random.split(sub_rng)
        uniforms.append(np.asarray(jax.random.uniform(sub, (1, 512), jnp.float32, 1e-20, 1.0)))
    inp["uniforms"], inp["temperature"] = np.stack(uniforms), np.array(TEMPERATURE)

    base = _random_params(config, rng)
    for variant in VARIANTS:
        text_params = fuse_stacked_projections(stack_decoder_layers(base["text"]))
        vision_params = base["vision"]
        if variant == "int4":
            text_params = quantize_stacked_params(text_params, quantize_embeddings=True,
                                                  mode="int4")
            vision_params = _quantize_vision_tree(vision_params, "int4")
        params = {"vision": vision_params, "text": text_params}
        _flatten(params, f"{variant}/params", inp)

        vision = vision_forward_25(
            config.vision, vision_params, jnp.asarray(padded),
            *(jnp.asarray(getattr(layout, f)) for f in
              ("gather_patch", "valid", "cos", "sin", "inv_merged", "inv_patch")),
            num_patches=jnp.int32(n_patches),
        )
        ref[f"{variant}/vision"] = np.asarray(vision)
        embeds = embed_multimodal(config, params, jnp.asarray(padded_ids), vision[:n_tokens])
        for mode in MODES:
            windows, con0 = budgets[mode]
            cache = KVCache.create(config.text.num_layers, 1, max_len,
                                   config.text.num_kv_heads, config.text.head_dim_,
                                   dtype=config.text.dtype)
            logits, cache = prefill_scan(config.text, text_params, embeds,
                                         jnp.asarray(positions), cache, jnp.asarray([seq_len]))
            ref[f"{variant}/prefill_logits"] = np.asarray(logits)
            constraint = DecodeConstraint(
                token_ok=jnp.asarray(tables.token_ok),
                token_trans=jnp.asarray(tables.token_trans),
                cost_after=jnp.asarray(tables.cost_after),
                **{k: jnp.asarray(v) for k, v in con0.items()},
            )
            sampling = dict(key=key, temperature=jnp.float32(TEMPERATURE)) \
                if mode.startswith("sampled") else {}
            tokens, valid, last, cache, _ = decode_loop_lookahead(
                config.text, text_params, logits, jnp.int32(next_pos), cache, constraint,
                jnp.asarray(tables.forced_token), jnp.asarray(tables.forced_state),
                num_windows=windows, window=WINDOW, eos_id=EOS, **sampling,
            )
            ref[f"{variant}/{mode}/tokens"] = np.asarray(tokens)
            ref[f"{variant}/{mode}/valid"] = np.asarray(valid)
            ref[f"{variant}/{mode}/lengths"] = np.asarray(cache.lengths)
    port = run_port("qwen25vl", inp, tmp_path_factory.mktemp("torch_qwen25vl"))
    return ref, port


@pytest.mark.parametrize("index", range(len(LAYOUTS)))
def test_window_layout_equal(sides, index):
    ref, port = sides
    for field in LAYOUT_FIELDS + ("sizes",):
        key = f"layout{index}/{field}"
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)


@pytest.mark.parametrize("index", range(len(RESIZES)))
def test_resize_weights_equal(sides, index):
    ref, port = sides
    np.testing.assert_array_equal(port[f"resize{index}"], ref[f"resize{index}"])


def test_device_preprocess_patches(sides):
    ref, port = sides
    np.testing.assert_allclose(port["patches"], ref["patches"], atol=1e-5, rtol=0)


def _atol(variant, ref):
    return 1e-4 if variant == "plain" else 2.0 ** -6 * np.abs(ref).max()


@pytest.mark.parametrize("variant", VARIANTS)
def test_vision_tower(sides, variant):
    ref, port = sides
    want = ref[f"{variant}/vision"]
    np.testing.assert_allclose(port[f"{variant}/vision"], want, atol=_atol(variant, want), rtol=0)


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_logits(sides, variant):
    ref, port = sides
    want = ref[f"{variant}/prefill_logits"]
    np.testing.assert_allclose(port[f"{variant}/prefill_logits"], want,
                               atol=_atol(variant, want), rtol=0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_lookahead_tokens_equal(sides, variant, mode):
    ref, port = sides
    key = f"{variant}/{mode}"
    want_tok, got_tok = ref[f"{key}/tokens"], port[f"{key}/tokens"]
    mismatch = np.argwhere(want_tok != got_tok)
    assert mismatch.size == 0, f"first differing (row, window, pos): {mismatch[0].tolist()}"
    np.testing.assert_array_equal(port[f"{key}/valid"], ref[f"{key}/valid"])
    np.testing.assert_array_equal(port[f"{key}/lengths"], ref[f"{key}/lengths"])
    assert ref[f"{key}/valid"].sum() > NUM_WINDOWS  # forced runs fast-forwarded
    if mode.endswith("to_eos"):  # the document closed, with EOS, inside the run
        tokens = ref[f"{key}/tokens"][ref[f"{key}/valid"]]
        assert (tokens == EOS).any()
        # The window that closes the document pads its forced tail with EOS.
        closed_at = int(np.argmax(tokens == EOS))
        assert EOS_MIN_TOKENS <= closed_at <= EOS_MAX_TOKENS, closed_at
