"""Image -> model-input preprocessing, host path.

The port's copy of ``vis_tpu.ops.preprocess``: decode -> smart-resize (dims
divisible by patch*merge, pixel budget) -> rescale/normalize (CLIP stats) ->
patchify (merge-window order), bit-exact with the HF Qwen2VLImageProcessor
(bicubic resize, same reshape/transpose).  The JAX package's optional native
C pass (``vis_tpu/native``) is not ported: ``preprocess_image`` always takes
the PIL/numpy branch, which is what the JAX package does when that extension
is not built.  The device path is ``vis_tpu_torch.ops.preprocess_device``;
both pick the same padded patch bucket (``patch_bucket_for``).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

PATCH_SIZE = 14
TEMPORAL_PATCH_SIZE = 2
MERGE_SIZE = 2
FACTOR = PATCH_SIZE * MERGE_SIZE  # 28

DEFAULT_MIN_PIXELS = 56 * 56
DEFAULT_MAX_PIXELS = 14 * 14 * 4 * 1280

# Padded patch-sequence buckets (multiples of merge_unit, MXU-friendly).
PATCH_BUCKETS = (256, 384, 512, 768, 1024, 2048, 4096, 8192, 16384)


def patch_bucket_for(n: int) -> int:
    """The padded patch-sequence length for `n` patches: the next bucket,
    or the next 256-multiple beyond the table.  ONE statement of the law —
    the host (ImagePatches.padded) and device (DeviceImagePatches.padded)
    preprocess paths must pick identical compiled shapes for the same
    image."""
    bucket = next((b for b in PATCH_BUCKETS if b >= n), None)
    if bucket is None:
        bucket = ((n + 255) // 256) * 256
    return bucket


def smart_resize(
    height: int,
    width: int,
    factor: int = FACTOR,
    min_pixels: int = DEFAULT_MIN_PIXELS,
    max_pixels: int = DEFAULT_MAX_PIXELS,
) -> Tuple[int, int]:
    """Target dimensions: divisible by `factor`, pixel count within budget,
    aspect ratio preserved as closely as possible (HF smart_resize parity)."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def clamp_longest_side(
    h_bar: int, w_bar: int, max_dim: Optional[int], factor: int = FACTOR
) -> Tuple[int, int]:
    """Enforce the reference's per-agent LONGEST-SIDE cap (2048 inspector /
    1024 auditor, reference vlm_inspector.py:46-88): the pixel-budget
    mapping alone is a no-op for both production values (dim^2 exceeds
    DEFAULT_MAX_PIXELS), and an elongated image can satisfy the area
    budget with a side far beyond the cap."""
    if max_dim is None:
        return h_bar, w_bar
    longest = max(h_bar, w_bar)
    if longest <= max_dim:
        return h_bar, w_bar
    scale = max_dim / longest
    return (
        max(factor, math.floor(h_bar * scale / factor) * factor),
        max(factor, math.floor(w_bar * scale / factor) * factor),
    )


@dataclasses.dataclass
class ImagePatches:
    """Preprocessed image ready for the vision tower."""

    patches: np.ndarray          # [num_patches, C*T*P*P] float32 (unpadded)
    grid_t: int
    grid_h: int
    grid_w: int

    @property
    def num_patches(self) -> int:
        return self.grid_t * self.grid_h * self.grid_w

    @property
    def num_tokens(self) -> int:
        """LLM-visible vision tokens after 2x2 merging."""
        return self.num_patches // (MERGE_SIZE * MERGE_SIZE)

    def padded(self, bucket: Optional[int] = None) -> Tuple[np.ndarray, int]:
        """Zero-pad the patch sequence to a bucket length; returns
        (padded_patches, bucket_len)."""
        n = self.num_patches
        if bucket is None:
            bucket = patch_bucket_for(n)
        if n > bucket:
            raise ValueError(f"{n} patches exceed bucket {bucket}")
        padded = np.zeros((bucket, self.patches.shape[1]), dtype=self.patches.dtype)
        padded[:n] = self.patches
        return padded, bucket


def patchify(pixels: np.ndarray, grid_h: int, grid_w: int) -> np.ndarray:
    """Arrange normalized pixels [T, C, H, W] into merge-window-major patches
    [grid_h*grid_w, C*T*P*P] (HF reshape/transpose parity)."""
    t, c, h, w = pixels.shape
    m, p = MERGE_SIZE, PATCH_SIZE
    grid_t = t // TEMPORAL_PATCH_SIZE
    x = pixels.reshape(
        grid_t, TEMPORAL_PATCH_SIZE, c,
        grid_h // m, m, p,
        grid_w // m, m, p,
    )
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(
        grid_t * grid_h * grid_w, c * TEMPORAL_PATCH_SIZE * p * p
    )


def preprocess_image(
    image_path,
    max_image_dim: Optional[int] = None,
    min_pixels: int = DEFAULT_MIN_PIXELS,
    max_pixels: int = DEFAULT_MAX_PIXELS,
) -> ImagePatches:
    """Host-path preprocessing of one image file.

    `max_image_dim` maps the reference's per-agent resolution caps
    (2048 inspector / 1024 auditor) onto the pixel budget.  The PIL/numpy
    path is bit-exact with the HF Qwen2-VL processor.
    """
    from vis_tpu_torch.ops.frame_cache import get_frame

    image = Image.fromarray(get_frame(image_path))  # shared one-shot decode
    if max_image_dim is not None:
        budget = max_image_dim * max_image_dim
        max_pixels = min(max_pixels, budget)
    h_bar, w_bar = smart_resize(
        image.height, image.width, FACTOR, min_pixels, max_pixels
    )
    h_bar, w_bar = clamp_longest_side(h_bar, w_bar, max_image_dim)
    grid_h, grid_w = h_bar // PATCH_SIZE, w_bar // PATCH_SIZE

    resized = image.resize((w_bar, h_bar), Image.BICUBIC)
    arr = np.asarray(resized, dtype=np.float32) / 255.0  # [H, W, C]
    arr = (arr - CLIP_MEAN) / CLIP_STD
    arr = arr.transpose(2, 0, 1)  # [C, H, W]
    # Single image: replicate along time to fill the temporal patch.
    frames = np.stack([arr] * TEMPORAL_PATCH_SIZE, axis=0)  # [T, C, H, W]
    patches = patchify(frames, grid_h, grid_w)
    return ImagePatches(patches=patches, grid_t=1, grid_h=grid_h, grid_w=grid_w)


def build_mrope_positions(
    prompt_len_before: int,
    grid_h: int,
    grid_w: int,
    text_len_after: int,
) -> Tuple[np.ndarray, int]:
    """M-RoPE position ids for [text, vision, text] sequences
    (HF Qwen2VL get_rope_index semantics for one image).

    Returns (positions [3, seq], next_position) where `next_position` seeds
    decode-step positions.  Text tokens advance all three streams together;
    vision tokens hold t at the text offset while h/w trace the *merged*
    grid (the LLM sees post-merge tokens).
    """
    llm_h = grid_h // MERGE_SIZE
    llm_w = grid_w // MERGE_SIZE
    n_vision = llm_h * llm_w
    seq = prompt_len_before + n_vision + text_len_after
    pos = np.zeros((3, seq), dtype=np.int32)

    # Leading text: all streams identical 0..L-1.
    for s in range(3):
        pos[s, :prompt_len_before] = np.arange(prompt_len_before)

    st = prompt_len_before
    t_idx = prompt_len_before  # temporal stream frozen at the text offset
    h_ids = np.repeat(np.arange(llm_h), llm_w)
    w_ids = np.tile(np.arange(llm_w), llm_h)
    pos[0, st : st + n_vision] = t_idx
    pos[1, st : st + n_vision] = t_idx + h_ids
    pos[2, st : st + n_vision] = t_idx + w_ids

    # Trailing text resumes after the max position used so far.
    next_pos = int(pos[:, : st + n_vision].max()) + 1 if n_vision else st
    tail = np.arange(text_len_after) + next_pos
    for s in range(3):
        pos[s, st + n_vision :] = tail
    return pos, int(pos.max()) + 1 if seq else 0


__all__ = [
    "smart_resize",
    "preprocess_image",
    "patchify",
    "ImagePatches",
    "build_mrope_positions",
    "CLIP_MEAN",
    "CLIP_STD",
    "PATCH_SIZE",
    "MERGE_SIZE",
    "TEMPORAL_PATCH_SIZE",
    "PATCH_BUCKETS",
    "patch_bucket_for",
]
