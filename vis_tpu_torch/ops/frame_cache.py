"""Device level of the shared decoded-frame cache, for torch devices.

Counterpart of ``vis_tpu.ops.frame_cache.get_device_frame``.  The host
level (one JPEG decode per file, keyed by path, mtime and size) is
``vis_tpu.ops.frame_cache.get_frame`` itself, imported, so the quality
gate and the inspector share one decode; this module adds the u8 frame
copied once per (file, device) to a torch device.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch

from vis_tpu.ops.frame_cache import _key, get_frame

_MAX_FRAMES = 8


class DeviceFrameCache:
    """Small LRU of u8 [H, W, 3] frames on torch devices."""

    def __init__(self, max_frames: int = _MAX_FRAMES):
        self.max_frames = max_frames
        self._lock = threading.Lock()
        self._frames: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()

    def get(self, image_path, device: torch.device) -> torch.Tensor:
        key = (_key(image_path), str(torch.device(device)))
        with self._lock:
            frame = self._frames.get(key)
            if frame is not None:
                self._frames.move_to_end(key)
                return frame
        frame = torch.from_numpy(get_frame(image_path).copy()).to(device)
        with self._lock:
            self._frames[key] = frame
            while len(self._frames) > self.max_frames:
                self._frames.popitem(last=False)
        return frame


__all__ = ["DeviceFrameCache"]
