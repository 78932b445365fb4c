"""Qwen2.5-VL configuration, the inspector's model family.

Counterpart of ``vis_tpu/models/qwen2_5_vl/config.py`` with torch dtypes:
the text stack is the common decoder with M-RoPE; the vision tower uses
RMSNorm, SwiGLU MLPs with biases and window attention, with a few
full-attention blocks (``fullatt_block_indexes``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from vis_tpu_torch.models.common.decoder import DecoderConfig


@dataclasses.dataclass(frozen=True)
class Qwen25VisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    out_hidden_size: int = 3584
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_input_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size ** 2

    @property
    def window_cells(self) -> int:
        """Merged cells per window side."""
        return self.window_size // self.spatial_merge_size // self.patch_size

    @property
    def window_patches(self) -> int:
        """Raw patches per attention window."""
        return (self.window_cells ** 2) * self.merge_unit


@dataclasses.dataclass(frozen=True)
class Qwen25VLConfig:
    vision: Qwen25VisionConfig
    text: DecoderConfig
    image_token_id: int = 151655
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    eos_token_id: int = 151645

    @staticmethod
    def tiny() -> "Qwen25VLConfig":
        """The JAX package's tiny test config, in f32."""
        return Qwen25VLConfig(
            vision=Qwen25VisionConfig(
                depth=4, hidden_size=64, intermediate_size=128, num_heads=4,
                out_hidden_size=64, window_size=56,
                fullatt_block_indexes=(1, 3), dtype=torch.float32,
            ),
            text=DecoderConfig(
                vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                num_kv_heads=2, intermediate_size=128, qkv_bias=True,
                mrope_section=(2, 3, 3), dtype=torch.float32,
            ),
            image_token_id=7, vision_start_token_id=5,
            vision_end_token_id=6, eos_token_id=4,
        )

    @staticmethod
    def qwen2_5_vl_7b() -> "Qwen25VLConfig":
        return Qwen25VLConfig(
            vision=Qwen25VisionConfig(),
            text=DecoderConfig(
                vocab_size=152064, hidden_size=3584, num_layers=28,
                num_heads=28, num_kv_heads=4, intermediate_size=18944,
                rope_theta=1_000_000.0, rms_norm_eps=1e-6, qkv_bias=True,
                mrope_section=(16, 24, 24), tie_word_embeddings=False,
            ),
        )


__all__ = ["Qwen25VisionConfig", "Qwen25VLConfig"]
