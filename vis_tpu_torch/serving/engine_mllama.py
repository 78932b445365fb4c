"""Mllama serving engine (the auditor): tiled vision encode, cross-attention
K/V once per request, then the loop engine's prefill and decode.

Counterpart of ``vis_tpu/serving/engine_mllama.py`` and of the Mllama
branches of ``vis_tpu/serving/engine.py``'s builders.  The cross K/V ride
the loop engine's ``aux`` for the whole request; only the self-attention
layers use the KV cache.  ``build_target_mllama_engine`` makes
Llama-3.2-11B-Vision at full width and depth with random int4 or int8
weights straight on the device, in the JAX package's target layout (fused
and quantized, the tower blocks' projections too);
``build_small_mllama_engine`` is the small profile the CPU tests drive.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from vis_tpu_torch.models.common.decoder import DecoderConfig
from vis_tpu_torch.models.common.layers import embed
from vis_tpu_torch.models.llama.mllama import (
    MllamaConfig,
    MllamaVisionConfig,
    compute_cross_kv,
    fuse_mllama_projections,
    init_params,
    mllama_logits,
    quantize_mllama_params,
    text_forward,
    vision_forward,
)
from vis_tpu_torch.ops.frame_cache import DeviceFrameCache
from vis_tpu_torch.ops.preprocess_mllama import preprocess_image_mllama
from vis_tpu_torch.ops.preprocess_mllama_device import preprocess_frame_mllama_device
from vis_tpu_torch.serving.engine import (
    ServingSettings,
    _random_floats,
    _random_layer_weight,
    random_q8,
)
from vis_tpu_torch.serving.loop_engine import LoopDecodeEngine, LoopEngineBackend
from vis_tpu_torch.serving.tokenizer import ByteTokenizer
from vis_tpu_torch.utils.logger import setup_logger, span

logger = setup_logger(__name__, level="INFO", component="ENGINE_MLLAMA")


class MllamaEngine(LoopDecodeEngine):
    """One Mllama model on one torch device.  Unfused parameters are fused
    (self-layer Q/K/V, every gate/up), then the text stack and vocab tables
    quantized by ``quantization`` / ``vocab_mode``; leaves already fused or
    quantized stay as they are."""

    span_prefix = "mllama"

    def __init__(self, name: str, config: MllamaConfig, params: Dict[str, Any], tokenizer,
                 device, settings: ServingSettings, quantization: str = "none",
                 vocab_mode: Optional[str] = None):
        if not any("qkv_proj" in layer for layer in params["text"]["layers"]):
            params = fuse_mllama_projections(config, params)
        if quantization in ("int4", "int8"):
            params = quantize_mllama_params(params, mode=quantization, vocab_mode=vocab_mode)
        elif quantization != "none":
            raise NotImplementedError(f"QUANTIZATION={quantization} is not ported yet")
        super().__init__(name, params, tokenizer, device, settings)
        self.config = config
        self._frames = DeviceFrameCache()

    # -- LoopDecodeEngine contract -------------------------------------------
    def _model_forward(self, embeds, positions, aux, cache, mask):
        return text_forward(self.config, self.params, embeds, positions, aux, cache, mask)

    def _model_logits(self, hidden):
        return mllama_logits(self.config, self.params, hidden)

    def _embed_tokens(self, token_ids):
        return embed(token_ids, self.params["text"]["embed_tokens"])

    def _prepare_aux(self, image_path: Optional[Path]):
        """Tile the image, encode it, and compute each cross layer's K/V
        (kept for the whole decode)."""
        if image_path is None:
            return None
        with span("mllama.preprocess", logger):
            if self.settings.device_preprocess:
                tiles = preprocess_frame_mllama_device(self._frames.get(image_path, self.device))
                pixels = tiles.tiles
            else:
                tiles = preprocess_image_mllama(image_path)
                pixels = torch.from_numpy(tiles.tiles).to(self.device)
            self._sync()
        with span("mllama.vision", logger):
            features = vision_forward(self.config.vision, self.params, pixels,
                                      tiles.aspect_ratio_id,
                                      torch.from_numpy(tiles.tile_mask).to(self.device))
            cross_kv = compute_cross_kv(self.config, self.params, features)
            self._sync()
        return cross_kv

    def _prompt_ids(self, prompt: str, aux) -> List[int]:
        ids = [self.tokenizer.image_token_id] if aux is not None else []
        return ids + self.tokenizer.encode(prompt)

    def _cache_geometry(self):
        tc = self.config.text
        return len(self.config.self_layer_indices), tc.num_kv_heads, tc.head_dim_, tc.dtype

    @property
    def _vocab_size(self) -> int:
        return self.config.text.vocab_size


MllamaEngineBackend = LoopEngineBackend


# ---------------------------------------------------------------------------
# Engine construction
# ---------------------------------------------------------------------------

def _random_target_params(cfg: MllamaConfig, gen: torch.Generator, device,
                          mode: str) -> Dict[str, Any]:
    """Llama-3.2-11B-Vision in its serving layout, made leaf by leaf on the
    device as the JAX package's target profile materializes it: self layers
    fused (qkv, gateup), cross layers' q/k/v apart and gate/up fused, every
    text projection and the tower blocks' projections (q/k/v/o, fc1, fc2)
    int4 or int8 by ``mode``, the vocab tables of the same precision with
    rows padded to 512.  The patch projection and the projector stay bf16:
    the reference quantizes the tower subtree by subtree, and its walk
    quantizes only weights found inside a dict.  Random bytes for
    quantized weights, N(0,1)*0.005+0.01 for every float leaf.  No bf16 copy
    of the model is staged.  The leaves' paths, shapes and dtypes are the
    JAX package's target layout (tested on a small config)."""
    make = _random_layer_weight(mode)

    def floats(*shape):
        return _random_floats(gen, *shape, device=device)

    def weight(out, inn):
        return make(gen, out=out, inn=inn, device=device)

    vc, tc = cfg.vision, cfg.text
    d, inter, n_tok = vc.hidden_size, vc.intermediate_size, vc.patches_per_tile
    tables = vc.num_aspect_ratios + 1

    def vision_block(gated: bool) -> Dict[str, Any]:
        block = {
            "input_norm": floats(d), "input_norm_bias": floats(d),
            "post_attn_norm": floats(d), "post_attn_norm_bias": floats(d),
            "q_proj": weight(d, d), "k_proj": weight(d, d), "v_proj": weight(d, d),
            "o_proj": weight(d, d),
            "fc1": weight(inter, d), "fc1_bias": floats(inter),
            "fc2": weight(d, inter), "fc2_bias": floats(d),
        }
        if gated:
            block.update(gate_attn=floats(1), gate_ffn=floats(1))
        return block

    params: Dict[str, Any] = {
        "patch_embed": floats(d, 3 * vc.patch_size ** 2),
        "class_embedding": floats(d), "pos_gate": floats(1), "pos_embedding": floats(n_tok, d),
        "tile_pos_emb": floats(tables, vc.max_num_tiles * n_tok * d),
        "pre_tile_emb": floats(tables, vc.max_num_tiles * d), "pre_tile_gate": floats(1),
        "post_tile_emb": floats(tables, vc.max_num_tiles * d), "post_tile_gate": floats(1),
        "ln_pre": floats(d), "ln_pre_bias": floats(d),
        "ln_post": floats(d), "ln_post_bias": floats(d),
        "local_layers": [vision_block(False) for _ in range(vc.num_layers)],
        "global_layers": [vision_block(True) for _ in range(vc.num_global_layers)],
        "projector": floats(tc.hidden_size, vc.output_dim),
        "projector_bias": floats(tc.hidden_size),
    }
    h, hd = tc.hidden_size, tc.head_dim_
    qdim, kvdim = tc.num_heads * hd, tc.num_kv_heads * hd

    def vocab(out):
        """A vocab table of ``out`` rows, padded to a multiple of 512."""
        rows = -(-out // 512) * 512
        if mode == "int4":
            return weight(rows, h)
        return random_q8(gen, rows, out, h, device)

    def mlp():
        return {"gateup_proj": weight(2 * tc.intermediate_size, h),
                "down_proj": weight(h, tc.intermediate_size)}

    layers = []
    for i in range(tc.num_layers):
        layer = {"input_norm": floats(h), "post_attn_norm": floats(h)}
        if i in cfg.cross_attention_layers:
            layer.update(q_proj=weight(qdim, h), k_proj=weight(kvdim, h),
                         v_proj=weight(kvdim, h), o_proj=weight(h, qdim),
                         q_norm=floats(hd), k_norm=floats(hd),
                         gate_attn=floats(1), gate_mlp=floats(1))
        else:
            layer.update(qkv_proj=weight(qdim + 2 * kvdim, h), o_proj=weight(h, qdim))
        layer["mlp"] = mlp()
        layers.append(layer)
    params["text"] = {"embed_tokens": vocab(tc.vocab_size + 8),  # + the image tokens' rows
                      "final_norm": floats(h), "layers": layers}
    if not tc.tie_word_embeddings:
        params["text"]["lm_head"] = vocab(tc.vocab_size)
    return params


def build_target_mllama_engine(role: str, device, seed: int,
                               settings: Optional[ServingSettings] = None,
                               quantization: str = "int4") -> MllamaEngine:
    """Llama-3.2-11B-Vision at full width and depth (32 + 8 tower layers,
    40 text layers with 8 cross layers) with random int4 or int8 weights."""
    device = torch.device(device)
    cfg = MllamaConfig.llama32_11b_vision()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = _random_target_params(cfg, gen, device, quantization)
    logger.info(f"{role}: target-scale Mllama-11B ({quantization}, random) on {device}")
    return MllamaEngine(f"target-{role}-mllama-11b", cfg, params,
                        ByteTokenizer(vocab_size=cfg.text.vocab_size), device,
                        settings or ServingSettings())


def small_mllama_config() -> MllamaConfig:
    """The JAX package's small Mllama dev profile."""
    return MllamaConfig(
        vision=MllamaVisionConfig(
            hidden_size=256, num_layers=4, num_global_layers=2, attention_heads=4,
            intermediate_size=704, intermediate_layers_indices=(1, 3),
        ),
        text=DecoderConfig(
            vocab_size=1024, hidden_size=1024, num_layers=8, num_heads=8,
            num_kv_heads=2, intermediate_size=2816, rope_theta=500000.0,
            qkv_bias=False, tie_word_embeddings=True,
        ),
        cross_attention_layers=(1, 5),
        image_token_id=261, eos_token_id=256,
    )


def build_small_mllama_engine(role: str, device, seed: int, quantization: str = "none",
                              vocab_mode: str = "int4",
                              settings: Optional[ServingSettings] = None) -> MllamaEngine:
    """The small profile: random-normal weights, fused, the text stack and
    vocab table int4 or int8 when ``quantization`` says so (the tower stays
    float, as in the JAX package's small profile)."""
    device = torch.device(device)
    cfg = small_mllama_config()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = init_params(cfg, gen, device)
    return MllamaEngine(f"dev-{role}-mllama", cfg, params,
                        ByteTokenizer(vocab_size=cfg.text.vocab_size), device,
                        settings or ServingSettings(), quantization, vocab_mode)


__all__ = [
    "MllamaEngine",
    "MllamaEngineBackend",
    "build_small_mllama_engine",
    "build_target_mllama_engine",
    "small_mllama_config",
]
