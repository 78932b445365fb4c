"""The yardstick's arithmetic: operations and bytes a run's work needs,
from a configuration file's ``model`` section and what the run served.

Counted from the shapes, never from the kernels that did the work, so the
numbers stay the same whatever kernel a later change puts on the path.
Operations are multiply-adds times two.  Bytes are what one weight pass
reads once: every projection's packed weights and scales, the norms, the
vocab head; the KV cache is read at its valid length.

Peaks are NVIDIA's published figures for one H100 SXM (dense, no
sparsity), at its full 700 W power limit.
"""

from __future__ import annotations

from typing import Any, Dict

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


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


def tower_flops(vc: Dict[str, Any], grid_h: int, grid_w: int) -> float:
    """Qwen2.5-VL's tower over one image of grid_h x grid_w patches: the
    projections, window attention in windows of window_size/14/2 merged
    cells a side, full attention in ``fullatt_block_indexes``, the merger."""
    d, inter = vc["hidden_size"], vc["intermediate_size"]
    m = vc["spatial_merge_size"]
    n = grid_h * grid_w
    patch = vc["in_chans"] * vc["temporal_patch_size"] * vc["patch_size"] ** 2
    proj = 2.0 * n * (patch * d)
    per_block = 2.0 * n * (3 * d * d + d * d + 3 * d * inter)
    wc = vc["window_size"] // vc["patch_size"] // m
    lh, lw = grid_h // m, grid_w // m
    win_sq = 0
    for r in range(0, lh, wc):
        for c in range(0, lw, wc):
            cells = min(wc, lh - r) * min(wc, lw - c)
            win_sq += (cells * m * m) ** 2
    full = len(vc["fullatt_block_indexes"])
    attn = 4.0 * d * (full * n * n + (vc["depth"] - full) * win_sq)
    merge = 2.0 * (n // (m * m)) * ((m * m * d) ** 2 + m * m * d * vc["out_hidden_size"])
    return proj + vc["depth"] * per_block + attn + merge


__all__ = [
    "PEAK_BF16_FLOPS", "PEAK_HBM_BYTES", "decode_bytes", "decode_flops",
    "kv_bytes_per_position", "prefill_flops", "tower_flops", "weight_bytes_per_pass",
]
