"""The port's Mllama (vis_tpu_torch/models/llama/mllama.py) against the JAX
package on MllamaConfig.tiny() in f32.  Weights come from the JAX side's
init_params, with every norm, tanh gate and bias redrawn at random (the init's
zero gates would switch the cross layers off), and are carried over with
from_jax_numpy.

- Tiny f32, at the JAX golden tests' own tolerance (atol 3e-4, rtol 1e-3):
  vision features (two tiles, the second masked as padding), each cross
  layer's K/V, text-only logits, multimodal logits; the port's cached
  decode (a 5-token prefill, then one token a step) equal to its own
  teacher-forced logits; the port's fused projections equal to the unfused
  ones (1e-5), plain and int8.
- int4 and int8 (quantize_mllama_params on the JAX side, q and scales
  carried over): the quantized bytes the port makes from the same float
  weights are equal to the JAX package's, and the multimodal logits are
  held to 2^-6 * max|ref| with the argmax equal: the int matmuls round
  their input to bf16, and the quantized embedding table puts the stream in
  bf16, so a last-bit difference upstream can flip a bf16 rounding.  At a
  position where the reference's top two logits lie within that bound of
  each other (a near-tie such rounding can break either way) the port's
  pick must be a token whose reference logit is within the bound of the
  best.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from vis_tpu.models.common.layers import causal_mask, embed
from vis_tpu.models.llama.mllama import (
    MllamaConfig,
    compute_cross_kv,
    fuse_mllama_projections,
    mllama_logits,
    quantize_mllama_params,
    text_forward,
    vision_forward,
)
from torch_port import flatten_params, mllama_params, run_port

ATOL, RTOL = 3e-4, 1e-3
SEQ, PREFIX, ASPECT_RATIO_ID = 12, 5, 2
TILE_MASK = np.array([1.0, 0.0], np.float32)  # the second tile is padding
MODES = ("int4", "int8")


def _logits(config, params, embeds_table, ids, cross_kv):
    s = ids.shape[1]
    embeds = jnp.take(embeds_table, jnp.asarray(ids), axis=0)
    positions = jnp.arange(s, dtype=jnp.int32)[None]
    hidden, _ = text_forward(config, params, embeds, positions, cross_kv, mask=causal_mask(s, s))
    return np.asarray(mllama_logits(config, params, hidden))


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    config = MllamaConfig.tiny()
    params = mllama_params(config, 21)
    rng = np.random.default_rng(8)
    vc = config.vision
    pixels = rng.standard_normal((2, 3, vc.image_size, vc.image_size)).astype(np.float32)
    text_ids = rng.integers(3, 250, (1, SEQ))
    mm_ids = text_ids.copy()
    mm_ids[0, 0] = config.image_token_id
    inp = flatten_params(params, "params", {})
    inp.update(pixels=pixels, tile_mask=TILE_MASK, aspect_ratio_id=np.array(ASPECT_RATIO_ID),
               text_ids=text_ids, mm_ids=mm_ids, prefix=np.array(PREFIX))

    ref = {}
    vision = vision_forward(vc, params, jnp.asarray(pixels), jnp.asarray(ASPECT_RATIO_ID),
                            jnp.asarray(TILE_MASK))
    ref["vision"] = np.asarray(vision)
    cross_kv = compute_cross_kv(config, params, vision)
    for i, (k, v) in enumerate(cross_kv):
        ref[f"cross{i}/k"], ref[f"cross{i}/v"] = np.asarray(k), np.asarray(v)
    table = params["text"]["embed_tokens"]
    ref["text_logits"] = _logits(config, params, table, text_ids, None)
    ref["mm_logits"] = _logits(config, params, table, mm_ids, cross_kv)
    for mode in MODES:
        quantized = quantize_mllama_params(fuse_mllama_projections(config, params), mode=mode)
        flatten_params(quantized, f"{mode}/params", inp)
        ref[f"{mode}/mm_logits"] = _logits(
            config, quantized, table, mm_ids, compute_cross_kv(config, quantized, vision))
        # The embedding gather through the quantized table, as the engine does.
        embeds = embed(jnp.asarray(mm_ids), quantized["text"]["embed_tokens"])
        hidden, _ = text_forward(config, quantized, embeds, jnp.arange(SEQ, dtype=jnp.int32)[None],
                                 compute_cross_kv(config, quantized, vision),
                                 mask=causal_mask(SEQ, SEQ))
        ref[f"{mode}/mm_logits_qembed"] = np.asarray(mllama_logits(config, quantized, hidden))
    port = run_port("mllama", inp, tmp_path_factory.mktemp("torch_mllama"))
    return ref, port


def test_vision_features(sides):
    ref, port = sides
    assert port["vision"].shape == ref["vision"].shape == (2, 17, 128)
    np.testing.assert_allclose(port["vision"], ref["vision"], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("part", ("k", "v"))
@pytest.mark.parametrize("layer", range(2))
def test_cross_kv(sides, layer, part):
    ref, port = sides
    key = f"cross{layer}/{part}"
    np.testing.assert_allclose(port[key], ref[key], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ("text_logits", "mm_logits"))
def test_logits(sides, name):
    ref, port = sides
    np.testing.assert_allclose(port[name], ref[name], atol=ATOL, rtol=RTOL)
    # the image changes the logits through the cross layers
    assert np.abs(ref["mm_logits"][0, 1:] - ref["text_logits"][0, 1:]).max() > 1e-3


def test_cached_decode_equals_teacher_forcing(sides):
    _, port = sides
    np.testing.assert_allclose(port["cached_logits"], port["mm_logits"][0, PREFIX - 1:],
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("variant", ("plain", "int8"))
def test_fused_equals_unfused(sides, variant):
    _, port = sides
    np.testing.assert_allclose(port[f"fused/{variant}"], port[f"unfused/{variant}"],
                               atol=1e-5, rtol=1e-5)
    assert port["fused_layout_ok"]


@pytest.mark.parametrize("mode", MODES)
def test_quantized_bytes_equal(sides, mode):
    _, port = sides
    assert port[f"{mode}/bytes_equal"], port[f"{mode}/bytes_differ"]


@pytest.mark.parametrize("embedding", ("float", "quantized"))
@pytest.mark.parametrize("mode", MODES)
def test_quantized_logits(sides, mode, embedding):
    ref, port = sides
    suffix = "" if embedding == "float" else "_qembed"
    want, got = ref[f"{mode}/mm_logits{suffix}"], port[f"{mode}/mm_logits{suffix}"]
    bound = 2.0 ** -6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=bound, rtol=0)
    # The argmax is equal wherever the reference's best logit leads its
    # runner-up by more than the bound (nearly every position); at a
    # near-tie the port's pick is one of the tied tokens.
    top2 = np.sort(want, -1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > bound
    picks = got.argmax(-1)
    assert decided.mean() >= 0.75, decided
    np.testing.assert_array_equal(picks[decided], want.argmax(-1)[decided])
    picked = np.take_along_axis(want, picks[..., None], -1)[..., 0]
    assert (picked >= top2[..., 1] - bound).all()
