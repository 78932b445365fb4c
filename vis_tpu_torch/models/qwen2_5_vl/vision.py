"""Qwen2.5-VL vision tower: window attention over a padded-window layout.

Counterpart of ``vis_tpu/models/qwen2_5_vl/vision.py``.  Merged 2x2 cells
are reordered into attention windows with every window kept at full size
(edge windows padded with masked slots); window blocks run one batched
dense attention over [n_windows, window_patches]; the full-attention blocks
run over the whole sequence, through flash attention (kernel C) on a CUDA
device for block-aligned grids of at least 1024 patches.  The layout arrays
come from ``window_layout``, a numpy copy of the JAX package's function
(with its rotary tables), tested equal to it.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vis_tpu_torch.models.common.layers import linear, rms_norm
from vis_tpu_torch.models.qwen2_5_vl.config import Qwen25VisionConfig
from vis_tpu_torch.ops.flash_attention import flash_attention

Params = Dict[str, Any]


class WindowLayout(NamedTuple):
    """Host-computed static layout for one (grid_h, grid_w, bucket)."""

    gather_patch: np.ndarray   # [win_len] source patch index (0 for padding)
    valid: np.ndarray          # [win_len] bool
    inv_merged: np.ndarray     # [n_merged] window slot of each original cell
    inv_patch: np.ndarray      # [src_len] window slot of each original patch
    cos: np.ndarray            # [win_len, head_dim] rotary, window order
    sin: np.ndarray
    n_windows: int
    win_len: int


def vision_rotary_tables(config: Qwen25VisionConfig, grid_h: int, grid_w: int,
                         theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin [seq, head_dim] for a patch grid in merge-window-major order."""
    m = config.spatial_merge_size
    h_ids = np.arange(grid_h).reshape(grid_h // m, m, 1, 1)
    h_ids = np.broadcast_to(h_ids, (grid_h // m, m, grid_w // m, m))
    h_ids = h_ids.transpose(0, 2, 1, 3).reshape(-1)
    w_ids = np.arange(grid_w).reshape(1, 1, grid_w // m, m)
    w_ids = np.broadcast_to(w_ids, (grid_h // m, m, grid_w // m, m))
    w_ids = w_ids.transpose(0, 2, 1, 3).reshape(-1)
    dim = config.head_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    half = np.concatenate(
        [h_ids[:, None] * inv_freq[None, :], w_ids[:, None] * inv_freq[None, :]],
        axis=-1,
    )
    full = np.concatenate([half, half], axis=-1)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


@lru_cache(maxsize=64)
def window_layout(config: Qwen25VisionConfig, grid_h: int, grid_w: int,
                  min_len: int = 0, src_len: int = 0) -> WindowLayout:
    """Padded-window permutation for a patch grid; ``min_len`` pads the
    window-ordered sequence with whole masked windows."""
    m = config.spatial_merge_size
    mu = config.merge_unit
    wc = config.window_cells
    llm_h, llm_w = grid_h // m, grid_w // m
    pad_h = (-llm_h) % wc
    pad_w = (-llm_w) % wc
    nwh, nww = (llm_h + pad_h) // wc, (llm_w + pad_w) // wc

    cell = np.full((llm_h + pad_h, llm_w + pad_w), -1, np.int64)
    cell[:llm_h, :llm_w] = np.arange(llm_h * llm_w).reshape(llm_h, llm_w)
    cells = cell.reshape(nwh, wc, nww, wc).transpose(0, 2, 1, 3).reshape(-1)
    n_windows = nwh * nww
    win_len = n_windows * config.window_patches
    if min_len > win_len:
        extra = min_len - win_len
        if extra % config.window_patches:
            raise ValueError(f"min_len {min_len} is not whole windows past {win_len}")
        cells = np.concatenate([cells, np.full(extra // mu, -1, np.int64)])
        n_windows += extra // config.window_patches
        win_len = min_len

    gather = (np.where(cells >= 0, cells, 0)[:, None] * mu
              + np.arange(mu)[None, :]).reshape(-1)
    valid = np.repeat(cells >= 0, mu)

    inv_merged = np.zeros(llm_h * llm_w, np.int64)
    slot_ids = np.nonzero(cells >= 0)[0]
    inv_merged[cells[slot_ids]] = slot_ids

    seq = grid_h * grid_w
    inv_patch = np.zeros(max(src_len, seq), np.int64)
    inv_patch[gather[valid]] = np.arange(win_len)[valid]

    cos, sin = vision_rotary_tables(config, grid_h, grid_w)
    cos_w = np.zeros((win_len, cos.shape[1]), np.float32)
    sin_w = np.zeros((win_len, sin.shape[1]), np.float32)
    cos_w[valid] = cos[gather[valid]]
    sin_w[valid] = sin[gather[valid]]
    return WindowLayout(
        gather_patch=gather.astype(np.int32), valid=valid,
        inv_merged=inv_merged.astype(np.int32), inv_patch=inv_patch.astype(np.int32),
        cos=cos_w, sin=sin_w, n_windows=n_windows, win_len=win_len,
    )


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _apply_vision_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x32 = x.to(torch.float32)
    return (x32 * cos[:, None, :] + _rotate_half(x32) * sin[:, None, :]).to(x.dtype)


def vision_forward_25(
    config: Qwen25VisionConfig, params: Params, patches: torch.Tensor,
    layout: WindowLayout, num_patches: Optional[int] = None,
) -> torch.Tensor:
    """Encode one image: patches [src_len, patch_input_dim] in original
    order -> [n_merged, out_hidden_size] in original merged order (rows past
    the real token count are garbage the caller slices off)."""
    device = patches.device
    wp = config.window_patches
    win_len = layout.win_len
    src_len = layout.inv_patch.shape[0]
    n_windows = win_len // wp
    # The JAX package's rule, with a CUDA device in place of the TPU backend.
    use_flash = device.type == "cuda" and src_len % 128 == 0 and src_len >= 1024
    if num_patches is None:
        num_patches = src_len

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    gather_patch = dev(layout.gather_patch).long()
    valid = dev(layout.valid)
    cos, sin = dev(layout.cos), dev(layout.sin)
    inv_patch = dev(layout.inv_patch).long()
    inv_merged = dev(layout.inv_merged).long()

    x = linear(patches[gather_patch].to(config.dtype), params["patch_embed"])
    x = torch.where(valid[:, None], x, torch.zeros((), dtype=x.dtype, device=device))

    scale = config.head_dim ** -0.5
    full_bias = torch.where(valid, 0.0, -1e30).to(torch.float32)[None, None, :]
    win_bias = torch.where(valid.reshape(n_windows, wp), 0.0, -1e30).to(torch.float32)
    eye = torch.eye(wp, dtype=torch.bool, device=device)
    diag_floor = torch.where(eye, -1e29, -float("inf")).to(torch.float32)
    heads, hd = config.num_heads, config.head_dim

    for i, block in enumerate(params["blocks"]):
        h = rms_norm(x, block["norm1"], eps=1e-6)
        qkv = linear(h, block["qkv"], block["qkv_bias"]).reshape(win_len, 3, heads, hd)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        q = _apply_vision_rope(q, cos, sin)
        k = _apply_vision_rope(k, cos, sin)
        if i in config.fullatt_block_indexes:
            if use_flash:
                # Kernel C masks a valid PREFIX: swap to original patch order
                # (valid patches first), attend, swap back.
                lengths = torch.tensor([num_patches], dtype=torch.int32, device=device)
                out = flash_attention(
                    q[inv_patch][None], k[inv_patch][None], v[inv_patch][None],
                    lengths=lengths, causal=False, sm_scale=scale,
                )[0][gather_patch]
            else:
                logits = torch.einsum("qhd,khd->hqk", q.to(torch.float32),
                                      k.to(torch.float32)) * scale + full_bias
                probs = torch.softmax(logits, dim=-1).to(v.dtype).to(torch.float32)
                out = torch.einsum("hqk,khd->qhd", probs, v.to(torch.float32))
        else:
            shape = (n_windows, wp, heads, hd)
            qw, kw, vw = (t.reshape(shape).to(torch.float32) for t in (q, k, v))
            logits = torch.einsum("bqhd,bkhd->bhqk", qw, kw) * scale
            logits = torch.maximum(logits + win_bias[:, None, None, :], diag_floor)
            probs = torch.softmax(logits, dim=-1).to(v.dtype).to(torch.float32)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, vw).reshape(win_len, heads, hd)
        out = out.to(x.dtype).reshape(win_len, config.hidden_size)
        x = x + linear(out, block["proj"], block["proj_bias"])
        h = rms_norm(x, block["norm2"], eps=1e-6)
        mlp = block["mlp"]
        gate = linear(h, mlp["gate_proj"], mlp["gate_bias"])
        up = linear(h, mlp["up_proj"], mlp["up_bias"])
        x = x + linear(gate * torch.sigmoid(gate) * up, mlp["down_proj"], mlp["down_bias"])

    merger = params["merger"]
    x = rms_norm(x, merger["ln_q"], eps=1e-6)
    x = x.reshape(win_len // config.merge_unit, config.merge_unit * config.hidden_size)
    h = torch.nn.functional.gelu(linear(x, merger["fc1"], merger["fc1_bias"]))
    merged = linear(h, merger["fc2"], merger["fc2_bias"])
    return merged[inv_merged]


__all__ = ["WindowLayout", "vision_forward_25", "vision_rotary_tables", "window_layout"]
