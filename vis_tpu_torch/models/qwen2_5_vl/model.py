"""Qwen2.5-VL assembly: random init, import of JAX-side parameters, and the
multimodal embedding (vision features spliced in at image-token slots).

Counterpart of ``vis_tpu/models/qwen2_5_vl/model.py`` and of
``embed_multimodal`` in ``vis_tpu/models/qwen2_vl/model.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from vis_tpu_torch.models.common.decoder import params_from_numpy
from vis_tpu_torch.models.common.layers import embed
from vis_tpu_torch.models.qwen2_5_vl.config import Qwen25VLConfig

Params = Dict[str, Any]


def init_params(config: Qwen25VLConfig, generator: torch.Generator,
                device="cpu", scale: float = 0.02) -> Params:
    """Random-normal weights (norms one, biases zero) in the per-layer
    layout of the JAX package's init_params."""
    vc, tc = config.vision, config.text

    def norm(*shape, dtype):
        return (scale * torch.randn(shape, generator=generator, device=device)).to(dtype)

    def ones(n, dtype):
        return torch.ones(n, dtype=dtype, device=device)

    def zeros(n, dtype):
        return torch.zeros(n, dtype=dtype, device=device)

    vd, d, inter = vc.dtype, vc.hidden_size, vc.intermediate_size
    merge_dim = d * vc.merge_unit
    vision = {
        "patch_embed": norm(d, vc.patch_input_dim, dtype=vd),
        "blocks": [
            {
                "norm1": ones(d, vd), "norm2": ones(d, vd),
                "qkv": norm(3 * d, d, dtype=vd), "qkv_bias": zeros(3 * d, vd),
                "proj": norm(d, d, dtype=vd), "proj_bias": zeros(d, vd),
                "mlp": {
                    "gate_proj": norm(inter, d, dtype=vd), "gate_bias": zeros(inter, vd),
                    "up_proj": norm(inter, d, dtype=vd), "up_bias": zeros(inter, vd),
                    "down_proj": norm(d, inter, dtype=vd), "down_bias": zeros(d, vd),
                },
            }
            for _ in range(vc.depth)
        ],
        "merger": {
            "ln_q": ones(d, vd),
            "fc1": norm(merge_dim, merge_dim, dtype=vd), "fc1_bias": zeros(merge_dim, vd),
            "fc2": norm(vc.out_hidden_size, merge_dim, dtype=vd),
            "fc2_bias": zeros(vc.out_hidden_size, vd),
        },
    }
    td, h, hd = tc.dtype, tc.hidden_size, tc.head_dim_
    text: Params = {
        "embed_tokens": norm(tc.vocab_size, h, dtype=td),
        "final_norm": ones(h, td),
        "layers": [],
    }
    if not tc.tie_word_embeddings:
        text["lm_head"] = norm(tc.vocab_size, h, dtype=td)
    for _ in range(tc.num_layers):
        layer = {
            "input_norm": ones(h, td), "post_attn_norm": ones(h, td),
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
        if tc.qkv_bias:
            layer["q_bias"] = zeros(tc.num_heads * hd, td)
            layer["k_bias"] = zeros(tc.num_kv_heads * hd, td)
            layer["v_bias"] = zeros(tc.num_kv_heads * hd, td)
        text["layers"].append(layer)
    return {"vision": vision, "text": text}


def from_jax_numpy(flat: Mapping[str, np.ndarray], config: Qwen25VLConfig,
                   device="cpu") -> Params:
    """Rebuild the port's parameter tree from the JAX package's, flattened to
    "/"-joined key paths -> numpy under "vision/" and "text/" (see
    ``params_from_numpy``).  Float leaves take each tower's dtype."""
    parts: Dict[str, Dict[str, np.ndarray]] = {"vision": {}, "text": {}}
    for path, value in flat.items():
        head, rest = path.split("/", 1)
        parts[head][rest] = value
    return {
        "vision": params_from_numpy(parts["vision"], config.vision.dtype, device),
        "text": params_from_numpy(parts["text"], config.text.dtype, device),
    }


def embed_multimodal(config: Qwen25VLConfig, params: Params, token_ids: torch.Tensor,
                     vision_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings [b, s, hidden] with vision features, in sequence
    order, placed at the image-token slots."""
    embeds = embed(token_ids, params["text"]["embed_tokens"])
    if vision_embeds is None:
        return embeds
    is_image = token_ids == config.image_token_id
    order = torch.cumsum(is_image.reshape(-1).to(torch.int64), 0) - 1
    order = order.clamp(0, vision_embeds.shape[0] - 1)
    gathered = vision_embeds[order].reshape(embeds.shape).to(embeds.dtype)
    return torch.where(is_image[..., None], gathered, embeds)


__all__ = ["embed_multimodal", "from_jax_numpy", "init_params"]
