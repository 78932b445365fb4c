"""Mllama image preprocessing: aspect-ratio tiling into 448x448 tiles.

The port's copy of ``vis_tpu.ops.preprocess_mllama``.  Host-path
counterpart of ops.preprocess (Qwen2-VL) for the auditor model: pick the
best supported tile arrangement for the image's aspect ratio, resize to fit
the tiled canvas (preserving aspect), zero-pad, split into tiles, and
normalize with CLIP statistics (the Llama-3.2-Vision checkpoint's
preprocessor config uses CLIP mean/std and bilinear resampling).

Semantics match the HF MllamaImageProcessor exactly (verified by
tests/test_engine_mllama.py::TestTilingHFParity on the original):
- canvas selection: smallest upscale >= 1 if any arrangement allows it,
  else the mildest downscale; ties broken by minimum canvas area,
- fit-to-canvas: each side's target is clip(side, tile, canvas_side); an
  image already within [tile, canvas] is NOT resized (floor + aspect kept),
- pad with raw zeros, then rescale 1/255 and normalize (so the padded
  region lands at -mean/std).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
from PIL import Image

from vis_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD

TILE_SIZE = 448
# (h_tiles, w_tiles) in HF aspect_ratio_id order (id = index + 1).
SUPPORTED_ASPECT_RATIOS: List[Tuple[int, int]] = [
    (1, 1), (1, 2), (1, 3), (1, 4), (2, 1), (2, 2), (3, 1), (4, 1),
]


def supported_aspect_ratios(max_tiles: int) -> List[Tuple[int, int]]:
    return [
        (a, b)
        for a in range(1, max_tiles + 1)
        for b in range(1, max_tiles + 1)
        if a * b <= max_tiles
    ]


@dataclasses.dataclass
class MllamaTiles:
    tiles: np.ndarray          # [num_tiles, 3, 448, 448] float32 normalized
    aspect_ratio_id: int       # 1-based index into SUPPORTED_ASPECT_RATIOS
    num_tiles: int

    @property
    def tile_mask(self) -> np.ndarray:
        return np.ones((self.num_tiles,), np.float32)


def select_aspect_ratio(width: int, height: int, max_tiles: int = 4) -> Tuple[int, int]:
    """Pick the (h_tiles, w_tiles) arrangement for this image.

    The limiting-side scale for each candidate canvas is
    min(canvas_h/h, canvas_w/w).  If any canvas allows upscaling (scale
    >= 1) the smallest such scale wins (least unnecessary canvas); else
    the largest scale < 1 wins (mildest downscale).  Ties break to the
    smallest canvas area (least padding).
    """
    ratios = supported_aspect_ratios(max_tiles)
    scales = [
        min(h_t * TILE_SIZE / height, w_t * TILE_SIZE / width)
        for h_t, w_t in ratios
    ]
    upscaling = [s for s in scales if s >= 1.0]
    selected = min(upscaling) if upscaling else max(s for s in scales if s < 1.0)
    candidates = [r for r, s in zip(ratios, scales) if s == selected]
    return min(candidates, key=lambda r: r[0] * r[1])


def fit_to_canvas(
    height: int, width: int, canvas_h: int, canvas_w: int,
    tile_size: int = TILE_SIZE,
) -> Tuple[int, int]:
    """New (height, width) to fit the canvas: each side targets
    clip(side, tile, canvas_side); the binding side scales the other with
    floor.  An image already inside [tile, canvas] keeps its size."""
    target_w = min(max(width, tile_size), canvas_w)
    target_h = min(max(height, tile_size), canvas_h)
    scale_h = target_h / height
    scale_w = target_w / width
    if scale_w < scale_h:
        new_w = target_w
        new_h = min(math.floor(height * scale_w) or 1, target_h)
    else:
        new_h = target_h
        new_w = min(math.floor(width * scale_h) or 1, target_w)
    return new_h, new_w


def preprocess_image_mllama(
    image_path, max_tiles: int = 4
) -> MllamaTiles:
    from vis_tpu_torch.ops.frame_cache import get_frame

    image = Image.fromarray(get_frame(image_path))  # shared one-shot decode
    h_t, w_t = select_aspect_ratio(image.width, image.height, max_tiles)
    canvas_w, canvas_h = w_t * TILE_SIZE, h_t * TILE_SIZE

    new_h, new_w = fit_to_canvas(image.height, image.width, canvas_h, canvas_w)
    if (new_w, new_h) != (image.width, image.height):
        image = image.resize((new_w, new_h), Image.BILINEAR)

    canvas = np.zeros((canvas_h, canvas_w, 3), np.float32)
    canvas[:new_h, :new_w] = np.asarray(image, np.float32)
    canvas = (canvas / 255.0 - CLIP_MEAN) / CLIP_STD
    canvas = canvas.transpose(2, 0, 1)  # [3, H, W]

    tiles = canvas.reshape(3, h_t, TILE_SIZE, w_t, TILE_SIZE)
    tiles = tiles.transpose(1, 3, 0, 2, 4).reshape(
        h_t * w_t, 3, TILE_SIZE, TILE_SIZE
    )
    # The id indexes the checkpoint's aspect-ratio embedding table, which
    # is laid out in supported_aspect_ratios(max_tiles) order — using the
    # max_tiles=4 constant list would mis-index any other tile budget.
    ratio_id = supported_aspect_ratios(max_tiles).index((h_t, w_t)) + 1
    return MllamaTiles(tiles=tiles, aspect_ratio_id=ratio_id,
                       num_tiles=h_t * w_t)


__all__ = ["preprocess_image_mllama", "MllamaTiles", "select_aspect_ratio",
           "fit_to_canvas", "supported_aspect_ratios",
           "SUPPORTED_ASPECT_RATIOS", "TILE_SIZE"]
