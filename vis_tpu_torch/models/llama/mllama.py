"""Mllama (Llama-3.2 Vision): tiled ViT + cross-attention decoder.

Counterpart of ``vis_tpu/models/llama/mllama.py`` (the auditor's model):
plain functions on tensors, parameters in the JAX package's per-layer
layout (vision and text layers are lists, not stacks).

Vision: 448x448 tiles -> 14x14 patch projection -> gated pre-tile
aspect-ratio embedding -> class token -> gated positional embedding ->
pre-LN -> local layers (post-layer snapshots kept at
``intermediate_layers_indices``) -> post-LN -> gated post-tile embedding ->
tanh-gated global layers -> the final states beside the snapshots,
interleaved on the last axis.

Text: a Llama decoder whose layers at ``cross_attention_layers`` are
tanh-gated cross-attention blocks (head RMSNorm on q and k; K/V from the
projected vision features, computed once per request).  The KV cache holds
the self-attention layers only.

Checkpoint conversion (``convert_hf_state_dict``, ``from_hf_config``) is not
ported: the engine refuses checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from vis_tpu_torch.models.common.decoder import DecoderConfig, lm_logits, params_from_numpy
from vis_tpu_torch.models.common.layers import (
    KVCache,
    apply_rope,
    attention_scores,
    layer_norm,
    linear,
    rms_norm,
    rope_cos_sin,
    swiglu_mlp,
)
from vis_tpu_torch.ops.quantized import (
    QuantizedWeight,
    QuantizedWeight4,
    quantize_weight,
    quantize_weight4,
)

Params = Dict[str, Any]

_LLAMA3_SCALING = (
    ("rope_type", "llama3"), ("factor", 8.0), ("low_freq_factor", 1.0),
    ("high_freq_factor", 4.0), ("original_max_position_embeddings", 8192),
)
# HF's additive mask value for a (padding query, padding key) pair.
_PAD_PAIR_MASK = -3.3895e38


@dataclasses.dataclass(frozen=True)
class MllamaVisionConfig:
    hidden_size: int = 1280
    num_layers: int = 32
    num_global_layers: int = 8
    attention_heads: int = 16
    image_size: int = 448
    patch_size: int = 14
    max_num_tiles: int = 4
    intermediate_size: int = 5120
    intermediate_layers_indices: Tuple[int, ...] = (3, 7, 15, 23, 30)
    num_aspect_ratios: int = 8   # len(supported_aspect_ratios)
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16

    @property
    def patches_per_tile(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1  # +1 class token

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.attention_heads

    @property
    def output_dim(self) -> int:
        """The final states beside the intermediate snapshots."""
        return self.hidden_size * (1 + len(self.intermediate_layers_indices))


@dataclasses.dataclass(frozen=True)
class MllamaConfig:
    vision: MllamaVisionConfig
    text: DecoderConfig
    cross_attention_layers: Tuple[int, ...] = (3, 8, 13, 18, 23, 28, 33, 38)
    image_token_id: int = 128256
    eos_token_id: int = 128009

    @classmethod
    def tiny(cls) -> "MllamaConfig":
        return cls(
            vision=MllamaVisionConfig(
                hidden_size=64, num_layers=2, num_global_layers=1,
                attention_heads=4, image_size=56, patch_size=14,
                max_num_tiles=2, intermediate_size=128,
                intermediate_layers_indices=(0,), num_aspect_ratios=3,
                dtype=torch.float32,
            ),
            text=DecoderConfig(
                vocab_size=256, hidden_size=64, num_layers=4, num_heads=4,
                num_kv_heads=2, intermediate_size=128, rope_theta=500000.0,
                rms_norm_eps=1e-5, qkv_bias=False, rope_scaling=_LLAMA3_SCALING,
                dtype=torch.float32,
            ),
            cross_attention_layers=(1, 3),
            image_token_id=250, eos_token_id=2,
        )

    @classmethod
    def llama32_11b_vision(cls, dtype=torch.bfloat16) -> "MllamaConfig":
        return cls(
            vision=MllamaVisionConfig(dtype=dtype),
            text=DecoderConfig(
                vocab_size=128256, hidden_size=4096, num_layers=40,
                num_heads=32, num_kv_heads=8, intermediate_size=14336,
                rope_theta=500000.0, rms_norm_eps=1e-5, qkv_bias=False,
                rope_scaling=_LLAMA3_SCALING, dtype=dtype,
            ),
        )

    @property
    def self_layer_indices(self) -> List[int]:
        return [i for i in range(self.text.num_layers)
                if i not in self.cross_attention_layers]


# ---------------------------------------------------------------------------
# Vision tower
# ---------------------------------------------------------------------------

def _gate(value: torch.Tensor, dtype) -> torch.Tensor:
    """tanh of a gate in f32, cast to the activation dtype before it
    multiplies."""
    return torch.tanh(value.to(torch.float32)).to(dtype)


def _vision_attention(block: Params, x: torch.Tensor, mask: torch.Tensor,
                      heads: int, head_dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    q = linear(x, block["q_proj"]).reshape(b, s, heads, head_dim)
    k = linear(x, block["k_proj"]).reshape(b, s, heads, head_dim)
    v = linear(x, block["v_proj"]).reshape(b, s, heads, head_dim)
    out = attention_scores(q, k, v, mask)
    return linear(out.reshape(b, s, heads * head_dim), block["o_proj"])


def _vision_layer(config: MllamaVisionConfig, block: Params, x: torch.Tensor,
                  mask: torch.Tensor, gated: bool) -> torch.Tensor:
    h = layer_norm(x, block["input_norm"], block["input_norm_bias"], eps=config.norm_eps)
    h = _vision_attention(block, h, mask, config.attention_heads, config.head_dim)
    if gated:
        h = _gate(block["gate_attn"], h.dtype) * h
    x = x + h
    h = layer_norm(x, block["post_attn_norm"], block["post_attn_norm_bias"],
                   eps=config.norm_eps)
    h = linear(h, block["fc1"], block["fc1_bias"])
    h = torch.nn.functional.gelu(h, approximate="none")
    h = linear(h, block["fc2"], block["fc2_bias"])
    if gated:
        h = _gate(block["gate_ffn"], h.dtype) * h
    return x + h


def vision_forward(config: MllamaVisionConfig, params: Params, pixel_tiles: torch.Tensor,
                   aspect_ratio_id: int, tile_mask: torch.Tensor) -> torch.Tensor:
    """Encode one image's tiles: pixel_tiles [num_tiles, C, H, W]
    normalized, ``aspect_ratio_id`` 1-based, tile_mask [num_tiles] (1 =
    valid).  Returns [num_tiles, patches_per_tile, output_dim]."""
    t = pixel_tiles.shape[0]
    p = config.patch_size
    grid = config.image_size // p
    n_patches = grid * grid
    d = config.hidden_size

    # The patch conv as a linear over [C, P, P] blocks in row-major order.
    x = pixel_tiles.reshape(t, 3, grid, p, grid, p).permute(0, 2, 4, 1, 3, 5)
    x = linear(x.reshape(t, n_patches, 3 * p * p).to(config.dtype), params["patch_embed"])

    pre_tile = params["pre_tile_emb"][aspect_ratio_id].reshape(config.max_num_tiles, 1, d)[:t]
    x = x + _gate(params["pre_tile_gate"], x.dtype) * pre_tile
    cls = params["class_embedding"][None, None, :].expand(t, 1, d).to(x.dtype)
    x = torch.cat([cls, x], dim=1)
    n_tok = n_patches + 1

    # Gated positional embedding, mixed in f32: (1 - tanh g) * pos + tanh g * tile_pos.
    gate = torch.tanh(params["pos_gate"].to(torch.float32))
    pos = (1.0 - gate) * params["pos_embedding"].to(torch.float32)
    x = x + pos[None].to(x.dtype)
    tile_pos = params["tile_pos_emb"][aspect_ratio_id].reshape(
        config.max_num_tiles, n_tok, d)[:t]
    x = x + (gate * tile_pos.to(torch.float32)).to(x.dtype)
    x = layer_norm(x, params["ln_pre"], params["ln_pre_bias"], eps=1e-5)

    # Each tile's tokens padded to a multiple of 8 (HF's layout).
    pad = (8 - n_tok % 8) % 8
    x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    padded_tok = n_tok + pad

    # HF's mask: a valid vector v over the flattened tokens, additive mask
    # outer(1 - v, 1 - v) * min.  Only (padding query, padding key) pairs
    # are masked: valid queries still see padded keys.
    valid = tile_mask.to(torch.float32)[:, None].expand(t, padded_tok).clone()
    if pad:
        valid[:, -pad:] = 0.0
    inv = 1.0 - valid.reshape(1, t * padded_tok)
    mask = ((inv[:, :, None] * inv[:, None, :]) * _PAD_PAIR_MASK)[:, None]

    seq = x.reshape(1, t * padded_tok, d)
    intermediates = []
    for idx, block in enumerate(params["local_layers"]):
        seq = _vision_layer(config, block, seq, mask, gated=False)
        if idx in config.intermediate_layers_indices:  # post-layer snapshots
            intermediates.append(seq)
    seq = layer_norm(seq, params["ln_post"], params["ln_post_bias"], eps=1e-5)
    post_tile = params["post_tile_emb"][aspect_ratio_id].reshape(config.max_num_tiles, 1, d)[:t]
    seq = seq.reshape(t, padded_tok, d)
    seq = seq + _gate(params["post_tile_gate"], seq.dtype) * post_tile
    seq = seq.reshape(1, t * padded_tok, d)
    for block in params["global_layers"]:
        seq = _vision_layer(config, block, seq, mask, gated=True)

    final = seq.reshape(t, padded_tok, d)[:, :n_tok]
    # [t, n_tok, d, n_inter] flattened: the snapshots interleave per feature.
    inter = torch.stack([s.reshape(t, padded_tok, d)[:, :n_tok] for s in intermediates],
                        dim=-1).reshape(t, n_tok, -1)
    return torch.cat([final, inter], dim=-1)


# ---------------------------------------------------------------------------
# Text model with cross-attention
# ---------------------------------------------------------------------------

def compute_cross_kv(config: MllamaConfig, params: Params,
                     vision_features: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Project the vision features [num_tiles, n_tok, output_dim] and
    compute each cross layer's (k, v), [1, S, kv_heads, head_dim]."""
    tc = config.text
    projected = linear(vision_features.to(tc.dtype), params["projector"],
                       params["projector_bias"])
    states = projected.reshape(1, -1, tc.hidden_size)
    s = states.shape[1]
    out = []
    for layer_idx in config.cross_attention_layers:
        layer = params["text"]["layers"][layer_idx]
        k = linear(states, layer["k_proj"]).reshape(1, s, tc.num_kv_heads, tc.head_dim_)
        k = rms_norm(k, layer["k_norm"], tc.rms_norm_eps)
        v = linear(states, layer["v_proj"]).reshape(1, s, tc.num_kv_heads, tc.head_dim_)
        out.append((k, v))
    return out


def _cross_attn_layer(tc: DecoderConfig, layer: Params, x: torch.Tensor,
                      cross_kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    b, s, _ = x.shape
    h = rms_norm(x, layer["input_norm"], tc.rms_norm_eps)
    q = linear(h, layer["q_proj"]).reshape(b, s, tc.num_heads, tc.head_dim_)
    q = rms_norm(q, layer["q_norm"], tc.rms_norm_eps)
    k, v = cross_kv
    k = k.expand(b, *k.shape[1:])
    v = v.expand(b, *v.shape[1:])
    out = attention_scores(q, k, v, None)
    out = linear(out.reshape(b, s, tc.num_heads * tc.head_dim_), layer["o_proj"])
    x = x + _gate(layer["gate_attn"], x.dtype) * out
    h = rms_norm(x, layer["post_attn_norm"], tc.rms_norm_eps)
    h = swiglu_mlp(h, layer["mlp"])
    return x + _gate(layer["gate_mlp"], x.dtype) * h


def _self_attn_layer(tc: DecoderConfig, layer: Params, self_idx: int, x: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor, cache: Optional[KVCache],
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    b, s, _ = x.shape
    hd = tc.head_dim_
    h = rms_norm(x, layer["input_norm"], tc.rms_norm_eps)
    if "qkv_proj" in layer:  # fused layout (fuse_mllama_projections)
        qdim, kvdim = tc.num_heads * hd, tc.num_kv_heads * hd
        qkv = linear(h, layer["qkv_proj"])
        q = qkv[..., :qdim].reshape(b, s, tc.num_heads, hd)
        k = qkv[..., qdim:qdim + kvdim].reshape(b, s, tc.num_kv_heads, hd)
        v = qkv[..., qdim + kvdim:].reshape(b, s, tc.num_kv_heads, hd)
    else:
        q = linear(h, layer["q_proj"]).reshape(b, s, tc.num_heads, hd)
        k = linear(h, layer["k_proj"]).reshape(b, s, tc.num_kv_heads, hd)
        v = linear(h, layer["v_proj"]).reshape(b, s, tc.num_kv_heads, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is not None:
        cache.update(self_idx, k, v)
        k, v = (t.to(q.dtype) for t in cache.layer(self_idx))
    out = attention_scores(q, k, v, mask)
    x = x + linear(out.reshape(b, s, tc.num_heads * hd), layer["o_proj"])
    h = rms_norm(x, layer["post_attn_norm"], tc.rms_norm_eps)
    return x + swiglu_mlp(h, layer["mlp"])


def text_forward(config: MllamaConfig, params: Params, input_embeds: torch.Tensor,
                 positions: torch.Tensor,
                 cross_kv: Optional[List[Tuple[torch.Tensor, torch.Tensor]]],
                 cache: Optional[KVCache] = None,
                 mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """The decoder over embedded inputs [b, s, hidden]; returns the final-
    normed hidden states.  ``cache`` holds the self layers only (its layer i
    is the i-th self-attention layer); each self layer writes its k/v at
    the cursors in place, and the cursors advance by s at the end.  With
    ``cross_kv`` None the cross layers are skipped (text-only, as HF)."""
    tc = config.text
    cos, sin = rope_cos_sin(positions, tc.head_dim_, tc.rope_theta, tc.rope_scaling_dict)
    x = input_embeds
    self_idx = 0
    for layer_idx, layer in enumerate(params["text"]["layers"]):
        if layer_idx in config.cross_attention_layers:
            if cross_kv is not None:
                pos_in_cross = config.cross_attention_layers.index(layer_idx)
                x = _cross_attn_layer(tc, layer, x, cross_kv[pos_in_cross])
            continue
        x = _self_attn_layer(tc, layer, self_idx, x, cos, sin, cache, mask)
        self_idx += 1
    x = rms_norm(x, params["text"]["final_norm"], tc.rms_norm_eps)
    if cache is not None:
        cache.advance(input_embeds.shape[1])
    return x, cache


def mllama_logits(config: MllamaConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    return lm_logits(config.text, params["text"], hidden)


# ---------------------------------------------------------------------------
# Parameter layout: fusion, quantization, init, carry-over
# ---------------------------------------------------------------------------

def _concat_out(ws) -> Any:
    """Concatenate [out, in] weights (or quantized weights: q and per-row
    scales) on the out axis; None when the leaf types differ."""
    if len({type(w) for w in ws}) != 1:
        return None
    if isinstance(ws[0], (QuantizedWeight, QuantizedWeight4)):
        return type(ws[0])(q=torch.cat([w.q for w in ws]), scale=torch.cat([w.scale for w in ws]))
    return torch.cat(ws)


def fuse_mllama_projections(config: MllamaConfig, params: Params) -> Params:
    """Concatenate each self layer's Q/K/V into qkv_proj and every text
    layer's gate/up into gateup_proj (rows independent, so the math is
    unchanged).  Cross layers keep q_proj and k/v apart: compute_cross_kv
    reads k_proj and v_proj.  A layer whose projections mix leaf types is
    left unfused."""
    text = dict(params["text"])
    layers = []
    for idx, layer in enumerate(text["layers"]):
        fused_layer = dict(layer)
        names = ("q_proj", "k_proj", "v_proj")
        if idx not in config.cross_attention_layers and all(n in layer for n in names):
            qkv = _concat_out([layer[n] for n in names])
            if qkv is not None:
                fused_layer["qkv_proj"] = qkv
                for n in names:
                    del fused_layer[n]
        mlp = dict(layer["mlp"])
        if "gate_proj" in mlp and "up_proj" in mlp:
            gateup = _concat_out([mlp["gate_proj"], mlp["up_proj"]])
            if gateup is not None:
                mlp["gateup_proj"] = gateup
                del mlp["gate_proj"], mlp["up_proj"]
        fused_layer["mlp"] = mlp
        layers.append(fused_layer)
    text["layers"] = layers
    out = {k: v for k, v in params.items() if k != "text"}
    out["text"] = text
    return out


def quantize_mllama_params(params: Params, mode: str = "int8",
                           vocab_mode: Optional[str] = None) -> Params:
    """Weight-only quantization (int8, or split-half int4) of the text
    stack's projections, and of the vocab tables (rows padded to 512) by
    ``vocab_mode`` (default ``mode``; "none" keeps them float).  Norms,
    gates and the vision tower stay as they are.  The same bytes as the JAX
    package's ``quantize_mllama_params``."""
    quantize = quantize_weight4 if mode == "int4" else quantize_weight
    vocab_mode = vocab_mode or mode
    quantize_vocab = {"int4": quantize_weight4, "none": None}.get(vocab_mode, quantize_weight)
    qtypes = (QuantizedWeight, QuantizedWeight4)
    text = dict(params["text"])
    layers = []
    for layer in text["layers"]:
        qlayer = dict(layer)
        for name in ("qkv_proj", "q_proj", "k_proj", "v_proj", "o_proj"):
            if name in qlayer and not isinstance(qlayer[name], qtypes):
                qlayer[name] = quantize(qlayer[name])
        mlp = dict(qlayer["mlp"])
        for name in ("gateup_proj", "gate_proj", "up_proj", "down_proj"):
            if name in mlp and not isinstance(mlp[name], qtypes):
                mlp[name] = quantize(mlp[name])
        qlayer["mlp"] = mlp
        layers.append(qlayer)
    text["layers"] = layers
    for name in ("embed_tokens", "lm_head"):
        if name in text and not isinstance(text[name], qtypes) and quantize_vocab is not None:
            text[name] = quantize_vocab(text[name], pad_out_multiple=512)
    out = dict(params)
    out["text"] = text
    return out


def init_params(config: MllamaConfig, generator: torch.Generator, device="cpu",
                scale: float = 0.02) -> Params:
    """Random-normal weights (norms one, biases and gates zero, global
    layers' gates 0.785) in the JAX package's layout, drawn from
    ``generator``."""
    vc, tc = config.vision, config.text

    def norm(*shape, dtype):
        return (scale * torch.randn(shape, generator=generator, device=device)).to(dtype)

    def full(*shape, dtype, value=0.0):
        return torch.full(shape, value, dtype=dtype, device=device)

    vd, d = vc.dtype, vc.hidden_size
    n_tok, max_ar = vc.patches_per_tile, vc.num_aspect_ratios  # ids 1..max_ar; row 0 pads

    def vision_block(gated: bool) -> Params:
        block = {
            "input_norm": full(d, dtype=vd, value=1.0), "input_norm_bias": full(d, dtype=vd),
            "post_attn_norm": full(d, dtype=vd, value=1.0),
            "post_attn_norm_bias": full(d, dtype=vd),
            "q_proj": norm(d, d, dtype=vd), "k_proj": norm(d, d, dtype=vd),
            "v_proj": norm(d, d, dtype=vd), "o_proj": norm(d, d, dtype=vd),
            "fc1": norm(vc.intermediate_size, d, dtype=vd),
            "fc1_bias": full(vc.intermediate_size, dtype=vd),
            "fc2": norm(d, vc.intermediate_size, dtype=vd), "fc2_bias": full(d, dtype=vd),
        }
        if gated:
            block["gate_attn"] = full(1, dtype=vd, value=0.785)
            block["gate_ffn"] = full(1, dtype=vd, value=0.785)
        return block

    params: Params = {
        "patch_embed": norm(d, 3 * vc.patch_size ** 2, dtype=vd),
        "class_embedding": norm(d, dtype=vd),
        "pos_gate": full(1, dtype=vd),
        "pos_embedding": norm(n_tok, d, dtype=vd),
        "tile_pos_emb": norm(max_ar + 1, vc.max_num_tiles * n_tok * d, dtype=vd),
        "pre_tile_emb": norm(max_ar + 1, vc.max_num_tiles * d, dtype=vd),
        "pre_tile_gate": full(1, dtype=vd),
        "post_tile_emb": norm(max_ar + 1, vc.max_num_tiles * d, dtype=vd),
        "post_tile_gate": full(1, dtype=vd),
        "ln_pre": full(d, dtype=vd, value=1.0), "ln_pre_bias": full(d, dtype=vd),
        "ln_post": full(d, dtype=vd, value=1.0), "ln_post_bias": full(d, dtype=vd),
        "local_layers": [vision_block(False) for _ in range(vc.num_layers)],
        "global_layers": [vision_block(True) for _ in range(vc.num_global_layers)],
        "projector": norm(tc.hidden_size, vc.output_dim, dtype=tc.dtype),
        "projector_bias": full(tc.hidden_size, dtype=tc.dtype),
    }
    td, h, hd = tc.dtype, tc.hidden_size, tc.head_dim_
    text: Params = {
        "embed_tokens": norm(tc.vocab_size + 8, h, dtype=td),  # + the image tokens' rows
        "final_norm": full(h, dtype=td, value=1.0),
        "layers": [],
    }
    if not tc.tie_word_embeddings:
        text["lm_head"] = norm(tc.vocab_size, h, dtype=td)
    for i in range(tc.num_layers):
        layer = {
            "input_norm": full(h, dtype=td, value=1.0),
            "post_attn_norm": full(h, dtype=td, value=1.0),
            "q_proj": norm(tc.num_heads * hd, h, dtype=td),
            "k_proj": norm(tc.num_kv_heads * hd, h, dtype=td),
            "v_proj": norm(tc.num_kv_heads * hd, h, dtype=td),
            "o_proj": norm(h, tc.num_heads * hd, dtype=td),
            "mlp": {
                "gate_proj": norm(tc.intermediate_size, h, dtype=td),
                "up_proj": norm(tc.intermediate_size, h, dtype=td),
                "down_proj": norm(h, tc.intermediate_size, dtype=td),
            },
        }
        if i in config.cross_attention_layers:
            layer.update(q_norm=full(hd, dtype=td, value=1.0), k_norm=full(hd, dtype=td, value=1.0),
                         gate_attn=full(1, dtype=td), gate_mlp=full(1, dtype=td))
        text["layers"].append(layer)
    params["text"] = text
    return params


def from_jax_numpy(flat: Mapping[str, np.ndarray], config: MllamaConfig,
                   device="cpu") -> Params:
    """The port's tree from the JAX package's, flattened to "/"-joined key
    paths -> numpy (list items by index; int4 and int8 quantized weights as
    ".../q" and ".../scale", see ``params_from_numpy``).  The text stack and
    the projector take the text dtype, the rest of the tower the vision
    dtype."""
    text = {k: v for k, v in flat.items() if k.startswith(("text/", "projector"))}
    vision = {k: v for k, v in flat.items() if k not in text}
    params = params_from_numpy(vision, config.vision.dtype, device)
    params.update(params_from_numpy(text, config.text.dtype, device))
    return params


__all__ = [
    "MllamaConfig",
    "MllamaVisionConfig",
    "compute_cross_kv",
    "from_jax_numpy",
    "fuse_mllama_projections",
    "init_params",
    "mllama_logits",
    "quantize_mllama_params",
    "text_forward",
    "vision_forward",
]
