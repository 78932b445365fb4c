"""Device-path Mllama tiling: resize -> round -> pad -> normalize -> tile.

Counterpart of ``vis_tpu/ops/preprocess_mllama_device.py``.  The tile
arrangement and the fit-to-canvas size are host integer arithmetic on the
frame's dimensions (``ops/preprocess_mllama.py``); the pixel work runs on
the frame's device: a bilinear resize as two matmuls against PIL-style
interpolation matrices (``resize_weights``), rounded and clipped to u8
levels as PIL writes its resize back to u8, the canvas zero-padded, CLIP
normalization and the tile split.  An image already inside [tile, canvas]
is not resampled (the host path keeps its size too).  Device tiles match
the host tiles within resampling tolerance; the host path is the HF-exact
reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vis_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD
from vis_tpu_torch.ops.preprocess_device import resize_weights
from vis_tpu_torch.ops.preprocess_mllama import (
    TILE_SIZE,
    fit_to_canvas,
    select_aspect_ratio,
    supported_aspect_ratios,
)


@dataclasses.dataclass
class MllamaTilesDevice:
    """MllamaTiles whose tile tensor lives on the frame's device."""

    tiles: torch.Tensor        # [num_tiles, 3, 448, 448] f32
    aspect_ratio_id: int
    num_tiles: int

    @property
    def tile_mask(self) -> np.ndarray:
        return np.ones((self.num_tiles,), np.float32)


def preprocess_frame_mllama_device(rgb_u8: torch.Tensor, max_tiles: int = 4) -> MllamaTilesDevice:
    """A decoded u8 [H, W, 3] frame on any device -> its tiles on that
    device (the auditor engine's path when DEVICE_PREPROCESS=true)."""
    device = rgb_u8.device
    src_h, src_w = rgb_u8.shape[:2]
    h_t, w_t = select_aspect_ratio(src_w, src_h, max_tiles)
    canvas_h, canvas_w = h_t * TILE_SIZE, w_t * TILE_SIZE
    new_h, new_w = fit_to_canvas(src_h, src_w, canvas_h, canvas_w)
    img = rgb_u8.to(torch.float32)                     # [H, W, 3], 0..255
    if (new_h, new_w) != (src_h, src_w):
        wh = torch.from_numpy(resize_weights(src_h, new_h, "bilinear")).to(device)
        ww = torch.from_numpy(resize_weights(src_w, new_w, "bilinear")).to(device)
        rows = torch.einsum("dh,hwc->dwc", wh, img)
        img = torch.einsum("ew,dwc->dec", ww, rows).round().clamp(0.0, 255.0)
    canvas = torch.nn.functional.pad(img, (0, 0, 0, canvas_w - new_w, 0, canvas_h - new_h))
    mean = torch.from_numpy(CLIP_MEAN).to(device)
    std = torch.from_numpy(CLIP_STD).to(device)
    chw = ((canvas / 255.0 - mean) / std).permute(2, 0, 1)
    tiles = chw.reshape(3, h_t, TILE_SIZE, w_t, TILE_SIZE).permute(1, 3, 0, 2, 4)
    # The id indexes the aspect-ratio embedding tables, laid out in
    # supported_aspect_ratios(max_tiles) order, as on the host path.
    ratio_id = supported_aspect_ratios(max_tiles).index((h_t, w_t)) + 1
    return MllamaTilesDevice(
        tiles=tiles.reshape(h_t * w_t, 3, TILE_SIZE, TILE_SIZE),
        aspect_ratio_id=ratio_id, num_tiles=h_t * w_t,
    )


__all__ = ["MllamaTilesDevice", "preprocess_frame_mllama_device"]
