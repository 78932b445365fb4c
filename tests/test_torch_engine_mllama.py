"""The port's Mllama engine (vis_tpu_torch/serving/engine_mllama.py on
loop_engine.py) against the JAX package's.

- Engine, on tests/test_engine_mllama.py's tiny engine (f32, vocab 512,
  4 text layers with cross layers 1 and 3, a 64-wide tower on 448-pixel
  tiles), weights from the JAX side (norms, gates and biases random)
  carried over: the inspection-schema lookahead decode (window 8) of an
  image request, greedy and sampled at temperature 0.1 with the JAX
  engine's own Gumbel uniforms (PRNGKey(0) folded per chunk, split per
  window) replayed into the port, and a free-form greedy text request.
  The generated token ids are exactly equal.
- Preprocessing: device tiles (DEVICE_PREPROCESS=true) against the JAX
  package's device tiles at 1e-5 (but for one-level rounding flips where
  a resampled value sits at a half level, on at most 1e-3 of the values;
  none without a resample), and against the host tiles at the JAX
  package's own bounds (resampled: max < 0.08, mean < 0.01 normalized;
  not resampled: < 1e-5); aspect-ratio ids and tile counts equal.  (The
  host tiles are held byte-equal in test_torch_standalone.py.)
- _quantize_vision_tree with the Mllama keys added: the Qwen2.5-VL tower's
  quantized leaves are the ones the former key set gave, and both towers'
  quantized leaves equal the JAX package's, byte for byte.
- Routing: build_engine sends Llama-3.2-11B-Vision to an MllamaEngine
  (the small profile here); the port's target and small configs equal
  the JAX package's field by field; KV_QUANTIZATION=int8, a checkpoint
  under CHECKPOINT_DIR and a missing CUDA device are refused, a budget
  that leaves no prompt room raises RuntimeError (constrained decode
  without a lookahead window and free-form sampled decode are held to the
  JAX engine's tokens in test_torch_decode_paths.py);
  the health check passes; the target builder's random leaves have the
  JAX package's target layout (paths, shapes, dtypes; small config).
- Pipeline: run_inspection on the CPU with the auditor on the port's small
  Mllama engine (int4) returns an auditor result that did not fail, whose
  JSON has the inspection schema's keys in order.
"""

import dataclasses
import json

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from vis_tpu.models.common.decoder import DecoderConfig
from vis_tpu.models.llama.mllama import (
    MllamaConfig,
    MllamaVisionConfig,
    fuse_mllama_projections,
    init_params as init_mllama,
    quantize_mllama_params,
)
from vis_tpu.ops.quantized import QuantizedWeight, QuantizedWeight4
from vis_tpu.models.qwen2_5_vl import Qwen25VLConfig, init_params as init_qwen25
from vis_tpu.ops.preprocess import CLIP_STD
from vis_tpu.ops.preprocess_mllama import preprocess_image_mllama
from vis_tpu.ops.preprocess_mllama_device import preprocess_image_mllama_device
from vis_tpu.serving.engine import _quantize_vision_tree
from vis_tpu.serving.engine_mllama import MllamaEngine
from vis_tpu.serving.schema import SCHEMAS
from vis_tpu.serving.tokenizer import ByteTokenizer
from vis_tpu.utils.config import get_config
from torch_port import flatten_params, mllama_params, run_port

VOCAB, MAX_CACHE, DECODE_CHUNK, WINDOW, CHUNKS = 512, 512, 64, 8, 4
PROMPT, MAX_TOKENS, MIN_TOKENS, TEMPERATURE = "Audit the image.", 160, 150, 0.1
MODES = {  # mode -> (image?, generate kwargs)
    "greedy": (True, dict(temperature=0.0, json_mode=True, json_schema="inspection",
                          max_tokens=MAX_TOKENS, min_tokens=MIN_TOKENS)),
    "sampled": (True, dict(temperature=TEMPERATURE, json_mode=True, json_schema="inspection",
                           max_tokens=MAX_TOKENS, min_tokens=MIN_TOKENS)),
    "free": (False, dict(temperature=0.0, max_tokens=12)),
}
TILE_SHAPES = [(300, 500), (448, 448), (100, 160), (2000, 3000), (900, 400), (768, 1024)]


def engine_config() -> MllamaConfig:
    """tests/test_engine_mllama.py's tiny engine."""
    return MllamaConfig(
        vision=MllamaVisionConfig(
            hidden_size=64, num_layers=2, num_global_layers=1, attention_heads=4,
            image_size=448, patch_size=14, max_num_tiles=4, intermediate_size=128,
            intermediate_layers_indices=(0,), num_aspect_ratios=8, dtype=jnp.float32,
        ),
        text=DecoderConfig(
            vocab_size=VOCAB, hidden_size=64, num_layers=4, num_heads=4, num_kv_heads=2,
            intermediate_size=128, qkv_bias=False, rms_norm_eps=1e-5,
            tie_word_embeddings=True, dtype=jnp.float32,
        ),
        cross_attention_layers=(1, 3), image_token_id=261, eos_token_id=256,
    )


def small_config() -> MllamaConfig:
    """The JAX package's small Mllama dev profile (serving/engine.py)."""
    return MllamaConfig(
        vision=MllamaVisionConfig(
            hidden_size=256, num_layers=4, num_global_layers=2, attention_heads=4,
            intermediate_size=704, intermediate_layers_indices=(1, 3),
        ),
        text=DecoderConfig(
            vocab_size=1024, hidden_size=1024, num_layers=8, num_heads=8, num_kv_heads=2,
            intermediate_size=2816, rope_theta=500000.0, qkv_bias=False,
            tie_word_embeddings=True,
        ),
        cross_attention_layers=(1, 5), image_token_id=261, eos_token_id=256,
    )


def config_json(config) -> str:
    """A config's fields as JSON, dtypes by name."""
    def plain(value):
        if isinstance(value, dict):
            return {k: plain(v) for k, v in value.items()}
        if isinstance(value, (tuple, list)):
            return [plain(v) for v in value]
        if isinstance(value, type) or hasattr(value, "dtype"):
            return np.dtype(value).name
        return value

    return json.dumps(plain(dataclasses.asdict(config)))


def recording_tokenizer(vocab: int) -> ByteTokenizer:
    """A ByteTokenizer that keeps the ids of its last decode (the engine's
    final decode is the whole generation).  The class stays ByteTokenizer:
    the constraint compilers accept it by name."""
    tok = ByteTokenizer(vocab_size=vocab)
    decode = tok.decode

    def recording(ids):
        tok.last = list(ids)
        return decode(ids)

    tok.decode = recording
    return tok


def _image(path, h, w, seed):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)).save(path)
    return str(path)


def _jax_uniforms():
    """The JAX loop engine's window uniforms, chunk after chunk: each chunk
    folds PRNGKey(0) by its index, each window splits the chunk's key."""
    out = []
    for chunk in range(CHUNKS):
        rng = jax.random.fold_in(jax.random.PRNGKey(0), chunk)
        for _ in range(DECODE_CHUNK):
            rng, sub = jax.random.split(rng)
            out.append(np.asarray(jax.random.uniform(sub, (1, VOCAB), jnp.float32, 1e-20, 1.0)))
    return np.stack(out)


def _jax_engine_runs(config, params, image):
    """The JAX engine's runs, its settings from the environment (the config
    proxy takes no attribute of its own: one would outlive the test)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (("CONSTRAINED_LOOKAHEAD", WINDOW), ("DECODE_CHUNK", DECODE_CHUNK),
                            ("DEVICE_PREPROCESS", "false"), ("QUANTIZATION", "none")):
            mp.setenv(name, str(value))
        get_config(reload=True)
        try:
            tok = recording_tokenizer(VOCAB)
            engine = MllamaEngine("tiny-mllama", config, params, tok, max_cache_tokens=MAX_CACHE)
            for mode, (with_image, kwargs) in MODES.items():
                out[f"{mode}/text"] = engine.generate(PROMPT, image if with_image else None,
                                                      **kwargs)
                out[f"{mode}/tokens"] = np.array(tok.last, np.int64)
        finally:
            mp.undo()
            get_config(reload=True)
    return out


def untied_small_config() -> MllamaConfig:
    """The small profile with a separate vocab head, as the 11B has."""
    config = small_config()
    return dataclasses.replace(config, text=dataclasses.replace(config.text,
                                                                tie_word_embeddings=False))


def _layout(tree, path, out):
    """path -> [shape, dtype name] of every array (or shape struct) leaf,
    a quantized weight as its q and scale."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _layout(v, f"{path}/{k}", out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _layout(v, f"{path}/{i}", out)
    elif isinstance(tree, (QuantizedWeight, QuantizedWeight4)):
        _layout(tree.q, f"{path}/q", out)
        _layout(tree.scale, f"{path}/scale", out)
    else:
        out[path] = [list(tree.shape), np.dtype(tree.dtype).name]
    return out


def _target_layout(config, mode):
    """The JAX package's target-profile Mllama tree (engine.py's
    make_mllama: init, fuse, quantize the text stack, _quantize_vision_tree
    on every other subtree) as _layout, by eval_shape."""
    def make(key):
        params = fuse_mllama_projections(config, init_mllama(config, key))
        params = quantize_mllama_params(params, mode=mode, vocab_mode=mode)
        return {name: (_quantize_vision_tree(v, mode) if name != "text" else v)
                for name, v in params.items()}

    return _layout(jax.eval_shape(make, jax.random.PRNGKey(0)), "", {})


def _vision_trees():
    """Float towers: the tiny Qwen2.5-VL's and the tiny Mllama's (every
    subtree but the text stack)."""
    qwen = init_qwen25(Qwen25VLConfig.tiny(), jax.random.PRNGKey(1))["vision"]
    mllama = mllama_params(MllamaConfig.tiny(), 2)
    return {"qwen": qwen, "mllama": {k: v for k, v in mllama.items() if k != "text"}}


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_engine_mllama")
    config = engine_config()
    params = mllama_params(config, 11)
    image = _image(tmp / "part.png", 300, 500, 4)
    ref = _jax_engine_runs(config, params, image)
    inp = flatten_params(params, "params", {})
    inp.update(config=np.array(config_json(config)), image=np.array(image),
               prompt=np.array(PROMPT), modes=np.array(json.dumps(MODES)),
               uniforms=_jax_uniforms(),
               settings=np.array([MAX_CACHE, DECODE_CHUNK, WINDOW]))

    tiles = []
    for i, (h, w) in enumerate(TILE_SHAPES):
        path = _image(tmp / f"tiles_{h}x{w}.png", h, w, 10 + i)
        host, dev = preprocess_image_mllama(path), preprocess_image_mllama_device(path)
        ref[f"tiles{i}/host"], ref[f"tiles{i}/device"] = host.tiles, np.asarray(dev.tiles)
        ref[f"tiles{i}/meta"] = np.array([dev.aspect_ratio_id, dev.num_tiles,
                                          host.aspect_ratio_id, host.num_tiles])
        tiles.append(path)
    inp["tile_images"] = np.array(json.dumps(tiles))

    for name, tree in _vision_trees().items():
        flatten_params(tree, f"towers/{name}/float", inp)
        for mode in ("int4", "int8"):
            flatten_params(_quantize_vision_tree(tree, mode), f"towers/{name}/{mode}", inp)
    inp["layout_config"] = np.array(config_json(untied_small_config()))
    for mode in ("int4", "int8"):
        ref[f"layout/{mode}"] = _target_layout(untied_small_config(), mode)
    inp["jax_configs"] = np.array(json.dumps({
        "target": json.loads(config_json(MllamaConfig.llama32_11b_vision())),
        "small": json.loads(config_json(small_config()))}))
    inp["workdir"] = np.array(str(tmp))
    port = run_port("engine_mllama", inp, tmp)
    return ref, port


@pytest.mark.parametrize("mode", MODES)
def test_engine_tokens_equal(sides, mode):
    ref, port = sides
    want, got = ref[f"{mode}/tokens"], port[f"{mode}/tokens"]
    assert got.tolist() == want.tolist()
    assert str(port[f"{mode}/text"]) == ref[f"{mode}/text"]
    if MODES[mode][1].get("json_mode"):
        doc = json.loads(ref[f"{mode}/text"])
        assert list(doc) == [k for k, _ in SCHEMAS["inspection"].props]
        assert MIN_TOKENS <= len(want) <= MAX_TOKENS


def test_sampled_decode_differs_from_greedy(sides):
    ref, _ = sides
    assert ref["sampled/tokens"].tolist() != ref["greedy/tokens"].tolist()


@pytest.mark.parametrize("index", range(len(TILE_SHAPES)))
def test_device_tiles(sides, index):
    ref, port = sides
    h, w = TILE_SHAPES[index]
    key = f"tiles{index}"
    meta = ref[f"{key}/meta"]
    assert port[f"{key}/meta"].tolist() == meta[:2].tolist() == meta[2:].tolist()
    got, want = port[f"{key}/device"], ref[f"{key}/device"]
    # Within 1e-5 of the JAX package's device tiles, but where the resize
    # lands within an f32 sum's last bits of a half level: there the two
    # frameworks' sums (in other orders) round to adjacent u8 levels, one
    # level apart (1 / 255 / std), on at most 1e-3 of the values.
    level = (1.0 / 255.0 / np.asarray(CLIP_STD, np.float32))[None, :, None, None]
    flip = np.abs(np.abs(got - want) - level) <= 1e-5
    np.testing.assert_allclose(np.where(flip, want, got), want, atol=1e-5, rtol=0)
    assert flip.mean() <= 1e-3, flip.mean()
    if (h, w) in ((300, 500), (448, 448)):
        assert not flip.any()
    diff = np.abs(got - ref[f"{key}/host"])
    if (h, w) in ((300, 500), (448, 448)):  # no resample on these: exact
        assert float(diff.max()) < 1e-5
    else:
        assert float(diff.max()) < 0.08 and float(diff.mean()) < 0.01


@pytest.mark.parametrize("tower", ("qwen", "mllama"))
@pytest.mark.parametrize("mode", ("int4", "int8"))
def test_vision_quantization(sides, tower, mode):
    _, port = sides
    assert port[f"towers/{tower}/{mode}/equal"], str(port[f"towers/{tower}/{mode}/differ"])
    assert int(port[f"towers/{tower}/{mode}/quantized"]) > 0


def test_qwen_tower_unchanged_by_the_mllama_keys(sides):
    _, port = sides
    assert port["towers/qwen/unchanged"]


@pytest.mark.parametrize("mode", ("int4", "int8"))
def test_target_layout_matches_the_jax_package(sides, mode):
    """The target builder makes its random leaves directly: their paths,
    shapes and dtypes are those of the JAX package's target profile (on the
    small config with a separate head; the 11B is too large to build here)."""
    ref, port = sides
    want, got = ref[f"layout/{mode}"], json.loads(str(port[f"layout/{mode}"]))
    assert sorted(got) == sorted(want)
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("profile", ("target", "small"))
def test_configs_equal(sides, profile):
    _, port = sides
    want = json.loads(str(port["jax_configs"]))[profile]
    assert json.loads(str(port[f"configs/{profile}"])) == want


def test_build_engine_routes_the_auditor(sides):
    _, port = sides
    assert json.loads(str(port["routing"])) == {
        "type": "MllamaEngine", "name": "dev-auditor-mllama",
        "backend": "cuda:dev-auditor-mllama", "layer0": "QuantizedWeight4",
        "cross_q": "QuantizedWeight4", "vision_q": "Tensor"}


@pytest.mark.parametrize("case", ("kv_int8", "checkpoint", "no_cuda", "no_room"))
def test_refusals(sides, case):
    _, port = sides
    assert str(port[f"refused/{case}"]), case


def test_health_check(sides):
    _, port = sides
    assert port["health"]


def test_pipeline_auditor_on_the_port(sides):
    _, port = sides
    result = json.loads(str(port["pipeline/auditor_result"]))
    assert result["analysis_failed"] is False, result.get("failure_reason")
    doc = json.loads(str(port["pipeline/raw"]))
    assert list(doc) == [k for k, _ in SCHEMAS["inspection"].props]
    assert str(port["pipeline/backend"]).startswith("cuda:dev-auditor-mllama")
