"""On-device preprocessing: resize -> clip -> CLIP-normalize -> patchify.

Counterpart of ``vis_tpu/ops/preprocess_device.py``.  The decoded u8 frame
goes to the device once; the bicubic resize runs as two matmuls against
PIL-style interpolation matrices (``resize_weights``, a copy of the JAX
package's numpy function, tested equal to it), then clip, CLIP
normalization and the merge-window patchify of
``vis_tpu.ops.preprocess.patchify`` (the same reshape and axis order,
written with ``permute``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from vis_tpu.ops.preprocess import (
    CLIP_MEAN,
    CLIP_STD,
    DEFAULT_MAX_PIXELS,
    DEFAULT_MIN_PIXELS,
    FACTOR,
    MERGE_SIZE,
    PATCH_SIZE,
    TEMPORAL_PATCH_SIZE,
    clamp_longest_side,
    patch_bucket_for,
    smart_resize,
)


def _bicubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0,
        np.where(ax < 2.0, a * ax**3 - 5.0 * a * ax**2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )


def _bilinear_kernel(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


_FILTERS = {
    "bicubic": (_bicubic_kernel, 2.0),
    "bilinear": (_bilinear_kernel, 1.0),
}


@lru_cache(maxsize=64)
def resize_weights(src: int, dst: int, filter: str = "bicubic") -> np.ndarray:
    """Dense [dst, src] separable interpolation matrix with PIL's support
    scaling (a downscale widens the kernel by the scale factor)."""
    kernel, base_support = _FILTERS[filter]
    scale = src / dst
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    weights = np.zeros((dst, src), np.float32)
    for i in range(dst):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), src)
        xs = np.arange(lo, hi, dtype=np.float64)
        w = kernel((xs + 0.5 - center) / filterscale)
        total = w.sum()
        if total != 0:
            weights[i, lo:hi] = (w / total).astype(np.float32)
    return weights


def patchify(pixels: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
    """[T, C, H, W] pixels -> merge-window-major [grid_h*grid_w, C*T*P*P]."""
    t, c = pixels.shape[:2]
    m, p = MERGE_SIZE, PATCH_SIZE
    grid_t = t // TEMPORAL_PATCH_SIZE
    x = pixels.reshape(grid_t, TEMPORAL_PATCH_SIZE, c, grid_h // m, m, p, grid_w // m, m, p)
    x = x.permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(grid_t * grid_h * grid_w, c * TEMPORAL_PATCH_SIZE * p * p)


def preprocess_frame_device(
    rgb_u8: torch.Tensor, dst_h: int, dst_w: int
) -> torch.Tensor:
    """u8 [H, W, 3] frame on any device -> [grid_h*grid_w, C*T*P*P] f32
    patches on the same device."""
    device = rgb_u8.device
    src_h, src_w = rgb_u8.shape[:2]
    wh = torch.from_numpy(resize_weights(src_h, dst_h)).to(device)
    ww = torch.from_numpy(resize_weights(src_w, dst_w)).to(device)
    img = rgb_u8.to(torch.float32) / 255.0
    rows = torch.einsum("dh,hwc->dwc", wh, img)
    resized = torch.einsum("ew,dwc->dec", ww, rows).clamp(0.0, 1.0)
    mean = torch.from_numpy(CLIP_MEAN).to(device)
    std = torch.from_numpy(CLIP_STD).to(device)
    chw = ((resized - mean) / std).permute(2, 0, 1)
    frames = torch.stack([chw] * TEMPORAL_PATCH_SIZE, dim=0)
    return patchify(frames, dst_h // PATCH_SIZE, dst_w // PATCH_SIZE)


@dataclass
class DeviceImagePatches:
    """Patches of one image on a torch device (ImagePatches' interface)."""

    patches: torch.Tensor  # [num_patches, C*T*P*P] f32
    grid_t: int
    grid_h: int
    grid_w: int

    @property
    def num_patches(self) -> int:
        return self.grid_t * self.grid_h * self.grid_w

    @property
    def num_tokens(self) -> int:
        return self.num_patches // (MERGE_SIZE * MERGE_SIZE)

    def padded(self) -> Tuple[torch.Tensor, int]:
        """Patches zero-padded to their bucket, and the bucket."""
        n = self.num_patches
        bucket = patch_bucket_for(n)
        return torch.nn.functional.pad(self.patches, (0, 0, 0, bucket - n)), bucket


def target_size(src_h: int, src_w: int, max_image_dim=None) -> Tuple[int, int]:
    """The resized (height, width): smart_resize then the longest-side cap."""
    max_pixels = DEFAULT_MAX_PIXELS
    if max_image_dim is not None:
        max_pixels = min(max_pixels, max_image_dim * max_image_dim)
    h_bar, w_bar = smart_resize(src_h, src_w, FACTOR, DEFAULT_MIN_PIXELS, max_pixels)
    return clamp_longest_side(h_bar, w_bar, max_image_dim)


def preprocess_image_device(rgb_u8: torch.Tensor, max_image_dim=None) -> DeviceImagePatches:
    """A decoded u8 frame on the device -> its patches on that device."""
    h_bar, w_bar = target_size(rgb_u8.shape[0], rgb_u8.shape[1], max_image_dim)
    return DeviceImagePatches(
        patches=preprocess_frame_device(rgb_u8, h_bar, w_bar), grid_t=1,
        grid_h=h_bar // PATCH_SIZE, grid_w=w_bar // PATCH_SIZE,
    )


__all__ = [
    "DeviceImagePatches",
    "patchify",
    "preprocess_frame_device",
    "preprocess_image_device",
    "resize_weights",
    "target_size",
]
