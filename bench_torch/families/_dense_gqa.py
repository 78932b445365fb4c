"""The dense GQA text decoder that the families share (Mistral, Llama, and
Qwen2.5-VL's with M-RoPE): its seeded leaves, the port's ``DecoderConfig``,
its plain float32 reference and its work arithmetic.

Its functions take a family's arguments, so a family whose model is this
decoder alone (``mistral.py``) re-exports them; one that adds to it
(``qwen2_5_vl.py``) calls them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence as Seq, Tuple

import torch

from bench_torch.harness.weights import SIGMA4, _Plan, vocab_rows
from bench_torch.reference.primitives import (
    EXACT, Precision, attention, dequant, embed_rows, lin, rms_norm, rope_tables, rotate_half,
)

# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def plan_weights(plan: _Plan, model: Dict[str, Any]) -> None:
    """The text leaves: embedding and head in ``head_quantization``, then
    the layers stacked, int4."""
    h, L = model["hidden_size"], model["num_hidden_layers"]
    heads, kv = model["num_attention_heads"], model["num_key_value_heads"]
    hd = model.get("head_dim") or h // heads
    inter, rows = model["intermediate_size"], vocab_rows(model["vocab_size"])
    t = ("text",)
    if model["head_quantization"] == "int4":
        plan.int4(t + ("embed_tokens",), (), rows, h)
        # Entries of standard deviation one: the embedding is not a projection.
        plan.float_leaves[-1] = (t + ("embed_tokens", "s"), (rows, 2), "scale", 1.0 / SIGMA4)
        plan.int4(t + ("lm_head",), (), rows, h)
    else:
        plan.int8(t + ("embed_tokens",), rows, h, 1.0)
        plan.int8(t + ("lm_head",), rows, h, 1.0 / math.sqrt(h))
    plan.norm(t + ("final_norm",), h)
    ls = t + ("layers_stacked",)
    plan.norm(ls + ("input_norm",), L, h)
    plan.norm(ls + ("post_attn_norm",), L, h)
    qkv_out = (heads + 2 * kv) * hd
    plan.int4(ls + ("qkv_proj",), (L,), qkv_out, h)
    if model.get("qkv_bias", False):
        plan.bias(ls + ("qkv_bias",), L, qkv_out)
    plan.int4(ls + ("o_proj",), (L,), h, heads * hd)
    plan.int4(ls + ("mlp", "gateup_proj"), (L,), 2 * inter, h)
    plan.int4(ls + ("mlp", "down_proj"), (L,), h, inter)


def finish_weights(tree: Dict[str, Any], model: Dict[str, Any]) -> Dict[str, Any]:
    """The head's end-of-sequence row at scale 0: with random weights the
    budget, not the model, ends an answer."""
    tree["text"]["lm_head"]["s"][model["eos_token_id"]] = 0.0
    return tree


# ---------------------------------------------------------------------------
# The program's config
# ---------------------------------------------------------------------------


def decoder_config(model: Dict[str, Any], mrope_section: Optional[Tuple[int, ...]] = None):
    from vis_tpu_torch.models.common.decoder import DecoderConfig

    return DecoderConfig(
        vocab_size=model["vocab_size"], hidden_size=model["hidden_size"],
        num_layers=model["num_hidden_layers"], num_heads=model["num_attention_heads"],
        num_kv_heads=model["num_key_value_heads"],
        intermediate_size=model["intermediate_size"], head_dim=model.get("head_dim"),
        rope_theta=float(model["rope_theta"]), rms_norm_eps=float(model["rms_norm_eps"]),
        qkv_bias=bool(model.get("qkv_bias", False)), mrope_section=mrope_section,
        tie_word_embeddings=bool(model.get("tie_word_embeddings", False)),
    )


def program_config(model: Dict[str, Any]):
    return decoder_config(model)


# ---------------------------------------------------------------------------
# Plain reference
# ---------------------------------------------------------------------------


@dataclass
class Sequence:
    """A check item as the reference reads it: token ids [n], their
    embeddings [n, h], rotary positions, and each served piece with its
    first row."""

    ids: torch.Tensor
    embeds: torch.Tensor
    positions: torch.Tensor
    served: List[Tuple[Dict[str, Any], int]]


def text_embeds(text: Dict[str, Any], ids: torch.Tensor) -> torch.Tensor:
    return embed_rows(text["embed_tokens"], ids)


def sequence(model: Dict[str, Any], item: Dict[str, Any], weights, device,
             prefix: Seq[int] = ()) -> Sequence:
    """The item's pieces in order after ``prefix`` ids, at positions 0..n-1."""
    ids: List[int] = list(prefix)
    served = []
    for piece in item["pieces"]:
        if piece.get("served"):
            served.append((piece, len(ids)))
        ids.extend(piece["ids"])
    ids_t = torch.tensor(ids, device=device)
    return Sequence(ids_t, text_embeds(weights["text"], ids_t),
                    torch.arange(len(ids), device=device), served)


def text_logits(model: Dict[str, Any], text: Dict[str, Any], embeds: torch.Tensor,
                positions: torch.Tensor, rows: torch.Tensor, prec: Precision = EXACT,
                sections: Optional[Seq[int]] = None) -> torch.Tensor:
    """Causal forward over embeds [n, h] at ``positions`` (rotary
    ``sections`` as ``rope_tables`` takes them); float32 logits
    [len(rows), vocab] at the sequence rows ``rows``."""
    h, L = model["hidden_size"], model["num_hidden_layers"]
    heads, kvh = model["num_attention_heads"], model["num_key_value_heads"]
    hd = model.get("head_dim") or h // heads
    eps = model["rms_norm_eps"]
    cos, sin = rope_tables(positions, hd, model["rope_theta"], sections)
    n = embeds.shape[0]
    idx = torch.arange(n, device=embeds.device)

    def causal(r):
        return idx[None, :] <= r[:, None]

    ls = text["layers_stacked"]
    x = embeds.to(torch.float32)
    for i in range(L):
        y = rms_norm(x, ls["input_norm"][i], eps)
        qkv = lin(y, dequant({k: v[i] for k, v in ls["qkv_proj"].items()}),
                  ls["qkv_bias"][i] if "qkv_bias" in ls else None, prec)
        q = qkv[:, :heads * hd].view(n, heads, hd)
        k = qkv[:, heads * hd:(heads + kvh) * hd].view(n, kvh, hd)
        v = qkv[:, (heads + kvh) * hd:].view(n, kvh, hd)
        q = q * cos[:, None] + rotate_half(q) * sin[:, None]
        k = k * cos[:, None] + rotate_half(k) * sin[:, None]
        att = attention(q, k, v, causal, prec).reshape(n, heads * hd)
        x = x + lin(att, dequant({k_: v_[i] for k_, v_ in ls["o_proj"].items()}), None, prec)
        y = rms_norm(x, ls["post_attn_norm"][i], eps)
        gate, up = lin(y, dequant({k_: v_[i] for k_, v_ in ls["mlp"]["gateup_proj"].items()}),
                       None, prec).chunk(2, dim=-1)
        down = dequant({k_: v_[i] for k_, v_ in ls["mlp"]["down_proj"].items()})
        x = x + lin(torch.nn.functional.silu(gate) * up, down, None, prec)
    y = rms_norm(x[rows], text["final_norm"], eps)
    return lin(y, dequant(text["lm_head"]), None, prec)[:, :model["vocab_size"]]


def logits(model: Dict[str, Any], weights, seq: Sequence, rows: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    return text_logits(model, weights["text"], seq.embeds, seq.positions, rows, prec)


# ---------------------------------------------------------------------------
# Work: operations (multiply-adds times two) and the bytes a decode pass
# reads once (every projection's packed weights and scales, the norms, the
# vocab head; the KV cache at its valid length)
# ---------------------------------------------------------------------------


def _text_dims(m: Dict[str, Any]):
    h, L = m["hidden_size"], m["num_hidden_layers"]
    heads, kv = m["num_attention_heads"], m["num_key_value_heads"]
    hd = m.get("head_dim") or h // heads
    return h, L, heads, kv, hd, m["intermediate_size"], m["vocab_size"]


def layer_params(m: Dict[str, Any]) -> int:
    h, L, heads, kv, hd, inter, _ = _text_dims(m)
    return h * (heads + 2 * kv) * hd + heads * hd * h + 3 * h * inter


def head_params(m: Dict[str, Any]) -> int:
    h, _, _, _, _, _, vocab = _text_dims(m)
    return h * vocab


def weight_bytes_per_pass(m: Dict[str, Any]) -> float:
    """Bytes one decode pass must read: int4 layers (half a byte a weight,
    two f32 scales a row), bf16 norms and biases, the vocab head in its
    stated precision with its scales."""
    h, L, heads, kv, hd, inter, vocab = _text_dims(m)
    rows = (heads + 2 * kv) * hd + h + 2 * inter + h
    per_layer = layer_params(m) / 2 + rows * 8 + 2 * h * 2
    if m.get("qkv_bias"):
        per_layer += (heads + 2 * kv) * hd * 2
    if m["head_quantization"] == "int4":
        head = vocab * h / 2 + vocab * 8
    else:
        head = vocab * h + vocab * 4
    return L * per_layer + head + h * 2


def kv_bytes_per_position(m: Dict[str, Any]) -> float:
    h, L, heads, kv, hd, _, _ = _text_dims(m)
    return L * 2 * kv * hd * 2


def attention_flops(m: Dict[str, Any], context_sum: float) -> float:
    """QK and PV products over ``context_sum`` keys in all (summed over
    the query rows)."""
    h, L, heads, kv, hd, _, _ = _text_dims(m)
    return 4.0 * L * heads * hd * context_sum


def prefill_flops(m: Dict[str, Any], n: int) -> float:
    """A causal prompt of n tokens, logits at its last row only."""
    return 2.0 * layer_params(m) * m["num_hidden_layers"] * n \
        + attention_flops(m, n * (n + 1) / 2) + 2.0 * head_params(m)


def decode_flops(m: Dict[str, Any], tokens: int, context_sum: float) -> float:
    return 2.0 * (layer_params(m) * m["num_hidden_layers"] + head_params(m)) * tokens \
        + attention_flops(m, context_sum)


def decode_bytes(m: Dict[str, Any], passes: int, context_sum: float) -> float:
    """``passes`` weight passes; ``context_sum`` cached positions read in
    all (summed over the passes)."""
    return weight_bytes_per_pass(m) * passes + kv_bytes_per_position(m) * context_sum


def input_flops(m: Dict[str, Any], record: Dict[str, Any]) -> float:
    """A text request's inputs cost nothing before its prompt."""
    return 0.0


__all__ = [
    "Sequence", "decode_bytes", "decode_flops", "decoder_config", "finish_weights",
    "input_flops", "kv_bytes_per_position", "logits", "plan_weights", "prefill_flops",
    "program_config", "sequence", "text_embeds", "text_logits", "weight_bytes_per_pass",
]
