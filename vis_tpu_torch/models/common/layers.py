"""Transformer primitives shared by the port's models.

Counterpart of ``vis_tpu/models/common/layers.py``: plain functions on
tensors.  Norms and softmax statistics run in f32; every matmul sums in f32
and returns f32 before the cast back (the JAX package's
``preferred_element_type=f32``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from vis_tpu_torch.ops.quantized import (
    QuantizedWeight,
    QuantizedWeight4,
    QuantizedWeight4Pick,
    embed_rows4,
    embed_rows8,
    fused_mlp_applies,
    fused_swiglu_mlp,
    quantized_linear,
    quantized_linear4,
    quantized_linear4_stacked,
)

Params = Dict[str, Any]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    variance = (x32 * x32).mean(dim=-1, keepdim=True)
    x32 = x32 * torch.rsqrt(variance + eps)
    return (x32 * weight.to(torch.float32)).to(x.dtype)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed and returned in f32 (inputs keep their rounding)."""
    return a.to(torch.float32) @ b.to(torch.float32)


def linear(x: torch.Tensor, weight: Any, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ W^T (+ b), W laid out [out, in]; int4 weights go to the int4
    matmuls (kernels A and B), int8 weights to kernel D."""
    if isinstance(weight, QuantizedWeight):
        return quantized_linear(x, weight, bias)
    if isinstance(weight, QuantizedWeight4):
        return quantized_linear4(x, weight, bias)
    if isinstance(weight, QuantizedWeight4Pick):
        return quantized_linear4_stacked(x, weight, bias)
    out = matmul_f32(x, weight.T)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def embed(token_ids: torch.Tensor, table: Any) -> torch.Tensor:
    if isinstance(table, QuantizedWeight):
        return embed_rows8(table, token_ids)
    if isinstance(table, QuantizedWeight4):
        return embed_rows4(table, token_ids)
    return table[token_ids]


def rope_frequencies(head_dim: int, theta: float, device=None,
                     rope_scaling: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Inverse frequencies [head_dim // 2], f32.  ``rope_scaling`` takes the
    Llama-3 scheme ({"rope_type": "llama3", "factor", "low_freq_factor",
    "high_freq_factor", "original_max_position_embeddings"}): low
    frequencies divided by ``factor``, high ones kept, the band between
    interpolated."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    if rope_scaling and rope_scaling.get("rope_type") == "llama3":
        factor = rope_scaling["factor"]
        low = rope_scaling["low_freq_factor"]
        high = rope_scaling["high_freq_factor"]
        old_len = rope_scaling["original_max_position_embeddings"]
        wavelen = 2 * math.pi / inv_freq
        scaled = inv_freq / factor
        smooth = (old_len / wavelen - low) / (high - low)
        interp = (1 - smooth) / factor * inv_freq + smooth * inv_freq
        inv_freq = torch.where(
            wavelen < old_len / high, inv_freq,
            torch.where(wavelen > old_len / low, scaled, interp),
        )
    return inv_freq


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float = 10000.0,
                 rope_scaling: Optional[Dict[str, Any]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [..., head_dim] (half-split layout) for integer positions."""
    inv_freq = rope_frequencies(head_dim, theta, positions.device, rope_scaling)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., seq, heads, head_dim]; cos/sin [..., seq, head_dim]."""
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    x32 = x.to(torch.float32)
    return (x32 * cos + _rotate_half(x32) * sin).to(x.dtype)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int,
                  mrope_section: Tuple[int, int, int],
                  theta: float = 1000000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE: positions [3, ...seq]; stream i owns its section of
    the frequency spectrum.  Returns cos/sin [...seq, head_dim]."""
    if sum(mrope_section) != head_dim // 2:
        raise ValueError(
            f"mrope_section {mrope_section} must sum to head_dim//2 = {head_dim // 2}"
        )
    inv_freq = rope_frequencies(head_dim, theta, positions.device)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    cos, sin = torch.cos(angles), torch.sin(angles)

    def select(table: torch.Tensor) -> torch.Tensor:
        chunks, start = [], 0
        for stream, span in enumerate(mrope_section):
            chunks.append(table[stream, ..., start:start + span])
            start += span
        half = torch.cat(chunks, dim=-1)
        return torch.cat([half, half], dim=-1)

    return select(cos), select(sin)


def causal_mask(sq: int, skv: int, device=None) -> torch.Tensor:
    """Additive [1, 1, sq, skv]: query i sees keys <= i."""
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(skv, device=device)[None, :]
    mask = torch.where(kj <= qi, 0.0, -1e30).to(torch.float32)
    return mask[None, None]


def length_mask(skv: int, lengths: torch.Tensor) -> torch.Tensor:
    """Additive [b, 1, 1, skv] hiding keys >= each row's length."""
    kj = torch.arange(skv, device=lengths.device)[None, :]
    mask = torch.where(kj < lengths[:, None], 0.0, -1e30).to(torch.float32)
    return mask[:, None, None, :]


@dataclasses.dataclass
class KVCache:
    """Dense per-layer KV buffers with per-row cursors.

    k/v: [n_layers, batch, max_len, kv_heads, head_dim]; lengths [batch]
    int32 on the device, plus a host copy (``lengths_host``) so the decode
    loop never reads the cursor back from the device.  The port updates the
    buffers in place (the JAX package's are immutable)."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    lengths_host: list

    @classmethod
    def create(cls, n_layers: int, batch: int, max_len: int, kv_heads: int,
               head_dim: int, dtype, device) -> "KVCache":
        shape = (n_layers, batch, max_len, kv_heads, head_dim)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
            lengths_host=[0] * batch,
        )

    def set_lengths(self, lengths) -> None:
        self.lengths_host = [int(n) for n in lengths]
        self.lengths = torch.tensor(self.lengths_host, dtype=torch.int32, device=self.k.device)


def swiglu_mlp(x: torch.Tensor, params: Params) -> torch.Tensor:
    """down(silu(gate(x)) * up(x)), with the fused gate+up layout.  Int8
    weights take kernel E for the whole MLP where the JAX package's rule
    sends them to its fused kernel (decode-sized rows); otherwise the
    projections run one by one."""
    if "gateup_proj" in params:
        gateup, down = params["gateup_proj"], params["down_proj"]
        if (isinstance(gateup, QuantizedWeight) and isinstance(down, QuantizedWeight)
                and fused_mlp_applies(x, gateup, down)):
            return fused_swiglu_mlp(x, gateup, down)
        gate, up = linear(x, gateup).chunk(2, dim=-1)
    else:
        gate = linear(x, params["gate_proj"])
        up = linear(x, params["up_proj"])
    return linear(gate * torch.sigmoid(gate) * up, params["down_proj"])


__all__ = [
    "KVCache",
    "Params",
    "apply_rope",
    "causal_mask",
    "embed",
    "length_mask",
    "linear",
    "matmul_f32",
    "mrope_cos_sin",
    "rms_norm",
    "rope_cos_sin",
    "rope_frequencies",
    "swiglu_mlp",
]
