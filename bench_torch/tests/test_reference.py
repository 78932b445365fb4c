"""The plain references against the port's CPU path, at tiny sizes.

Run: ``python -m pytest bench_torch/tests -q`` (CPU, about a minute).
Weights are the benchmark's seeded leaves; the port gets them in its
serving layout (``harness/engines.py``), the reference dequantizes them
itself.  The port computes in bf16, so the tolerances are bf16 ones: its
last logits read 1.5-2.5% of their spread off the reference, the float8
control 19-25% (200-token prompts, three seeds), so the text test allows
5%.
"""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_torch.families import family_of  # noqa: E402
from bench_torch.families import qwen2_5_vl as qwen  # noqa: E402
from bench_torch.harness.engines import _program_leaves  # noqa: E402
from bench_torch.harness.photos import photo_array  # noqa: E402
from bench_torch.harness.weights import make_weights  # noqa: E402
from bench_torch.reference import primitives as ref  # noqa: E402

CONFIGS = ROOT / "bench_torch" / "configs"


def tiny(name):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    model = dict(cfg["model"])
    model.update(cfg["rehearsal"]["model"])
    return model


def program_logits(model, weights, ids, positions):
    """The port's prefill over ids (CPU path) -> last-position logits."""
    from vis_tpu_torch.models.common.decoder import prefill_scan
    from vis_tpu_torch.models.common.layers import KVCache, embed

    cfg = family_of(model).program_config(model)
    tc = cfg if not hasattr(cfg, "text") else cfg.text
    params = _program_leaves(copy.copy(weights))["text"]
    n = ids.shape[0]
    cache = KVCache.create(tc.num_layers, 1, n, tc.num_kv_heads, tc.head_dim_, tc.dtype, "cpu")
    x = embed(ids[None], params["embed_tokens"])
    logits, _ = prefill_scan(tc, params, x, positions, cache, [n])
    return logits[0].float()


@pytest.mark.parametrize("name", ["mistral_7b_v0_3", "qwen2_5_vl_7b"])
def test_text_decoder_matches_the_port(name):
    model = tiny(name)
    weights = make_weights(model, 12345, "cpu")
    ids = torch.randint(0, 256, (40,), generator=torch.Generator().manual_seed(1))
    got = program_logits(model, weights, ids, torch.arange(40)[None])
    family = family_of(model)
    with ref.exact_matmuls():
        seq = family.sequence(model, {"pieces": [{"ids": ids.tolist()}]}, weights, "cpu")
        want = family.logits(model, weights, seq, torch.tensor([39]), ref.EXACT)[0]
    assert float((got - want).abs().max()) < 0.05 * float(want.std())


def test_vision_tower_matches_the_port():
    from vis_tpu_torch.models.qwen2_5_vl.vision import vision_forward_25, window_layout
    from vis_tpu_torch.ops.preprocess_device import preprocess_frame_device

    model = tiny("qwen2_5_vl_7b")
    # The tower alone, its merger out at the tower's own width (the
    # tolerance below was read there).
    vc = model["vision_config"] = dict(model["vision_config"], out_hidden_size=64)
    weights = make_weights(model, 777, "cpu")
    img = torch.from_numpy(photo_array({"seed": 9, "index": 0, "height": 168, "width": 252}))
    cfg = qwen.program_config(model).vision
    patches = preprocess_frame_device(img, 168, 252)
    assert torch.allclose(patches, qwen.image_patches(qwen.resize(img, 168, 252), vc), atol=1e-6)
    layout = window_layout(cfg, 12, 18, src_len=patches.shape[0])
    params = _program_leaves(copy.copy(weights))["vision"]
    got = vision_forward_25(cfg, params, patches, layout).float()
    with ref.exact_matmuls():
        want = qwen.vision_embeds(vc, weights["vision"], qwen.resize(img, 168, 252))
    assert got.shape == want.shape
    # bf16 reads about 2%; attention over the whole image instead of its
    # windows reads 6.7%, windows of half the size 4.3%.
    assert float((got - want).abs().max()) < 0.035 * float(want.std())


def test_camera_photos_resize_as_the_port_serves_them():
    from vis_tpu_torch.ops.preprocess_device import preprocess_frame_device, target_size

    proc = tiny("qwen2_5_vl_7b")["image_processor"]
    for h, w in ((480, 640), (768, 1024), (960, 1280), (1280, 960), (3000, 40), (30, 50)):
        assert qwen.served_size(h, w, proc, 28) == target_size(h, w, proc["max_image_dimension"])
    vc = tiny("qwen2_5_vl_7b")["vision_config"]
    for h, w in ((100, 140), (150, 90)):  # down- and upscales of each side
        img = torch.from_numpy(photo_array({"seed": 11, "index": 1, "height": h, "width": w}))
        dh, dw = qwen.served_size(h, w, proc, 28)
        got = preprocess_frame_device(img, dh, dw)
        want = qwen.image_patches(qwen.resize(img, dh, dw), vc)
        assert float((got - want).abs().max()) < 1e-5


def test_mrope_positions_match_the_port():
    from vis_tpu_torch.ops.preprocess import build_mrope_positions

    for gh, gw, after in ((6, 8, 10), (34, 46, 2583)):
        want, _ = build_mrope_positions(1, gh, gw, after)
        got = qwen.mrope_positions(1, gh, gw, 2, after)
        assert np.array_equal(got.numpy(), want)


def test_fp8_control_rounds_and_exact_does_not():
    x = torch.randn(4, 64)
    assert torch.equal(ref.EXACT(x), x)
    y = ref.FP8(x)
    err = (y - x).abs().max() / x.abs().max()
    assert 0 < float(err) < 0.07
