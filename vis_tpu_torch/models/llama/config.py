"""Llama text configurations (the explainer role), as DecoderConfigs.

Counterpart of ``vis_tpu/models/llama/config.py``: no attention bias,
standard RoPE with the Llama-3 frequency scaling.
"""

from __future__ import annotations

import torch

from vis_tpu_torch.models.common.decoder import DecoderConfig

_LLAMA3_SCALING = (
    ("rope_type", "llama3"),
    ("factor", 8.0),
    ("low_freq_factor", 1.0),
    ("high_freq_factor", 4.0),
    ("original_max_position_embeddings", 8192),
)


def llama31_8b(dtype=torch.bfloat16) -> DecoderConfig:
    return DecoderConfig(
        vocab_size=128256, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=8, intermediate_size=14336, rope_theta=500000.0,
        rms_norm_eps=1e-5, qkv_bias=False, rope_scaling=_LLAMA3_SCALING,
        dtype=dtype,
    )


def llama_tiny() -> DecoderConfig:
    """The JAX package's CPU-testable config."""
    return DecoderConfig(
        vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=128, rope_theta=500000.0,
        rms_norm_eps=1e-5, qkv_bias=False, rope_scaling=_LLAMA3_SCALING,
        dtype=torch.float32,
    )


__all__ = ["llama31_8b", "llama_tiny"]
