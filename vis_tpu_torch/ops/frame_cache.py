"""Shared decoded-frame cache: JPEG-decode each source image once.

The host level is the port's copy of ``vis_tpu.ops.frame_cache``'s:
``get_frame(path)`` -> np.uint8 [H, W, 3] RGB, decoded once and keyed by
(realpath, mtime_ns, size) so edited or re-uploaded files never alias; the
quality gate, the inspector's preprocess and the report overlays share one
decode.  Concurrent first touches of one image coalesce on a per-key lock.
Entries are read-only.

The device level is ``DeviceFrameCache``: the u8 frame copied once per
(file, torch device); each engine owns one.  The JAX package's jax device
prefetch is not copied.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

import numpy as np
import torch

_MAX_FRAMES = 8
_MAX_KEY_LOCKS = 64

_lock = threading.Lock()  # guards the maps below (never held over work)
_host_frames: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
_key_locks: dict = {}


def _key(image_path) -> tuple:
    p = os.path.realpath(str(image_path))
    st = os.stat(p)
    return (p, st.st_mtime_ns, st.st_size)


def _key_lock(key) -> threading.Lock:
    with _lock:
        lk = _key_locks.get(key)
        if lk is None:
            if len(_key_locks) >= _MAX_KEY_LOCKS:
                # Prune locks for keys no longer cached.  A racing holder
                # of a pruned lock at worst duplicates one decode.
                for stale in [k for k in _key_locks if k not in _host_frames]:
                    del _key_locks[stale]
            lk = _key_locks[key] = threading.Lock()
        return lk


def _decode(image_path) -> np.ndarray:
    from PIL import Image

    with Image.open(image_path) as im:
        rgb = np.asarray(im.convert("RGB"), dtype=np.uint8)
    rgb.setflags(write=False)
    return rgb


def get_frame(image_path) -> np.ndarray:
    """Decoded RGB u8 frame, cached by file identity. Read-only."""
    key = _key(image_path)
    with _lock:
        frame = _host_frames.get(key)
        if frame is not None:
            _host_frames.move_to_end(key)
            return frame
    with _key_lock(key):
        with _lock:
            frame = _host_frames.get(key)
            if frame is not None:
                _host_frames.move_to_end(key)
                return frame
        frame = _decode(image_path)
        with _lock:
            _host_frames[key] = frame
            while len(_host_frames) > _MAX_FRAMES:
                _host_frames.popitem(last=False)
        return frame


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


__all__ = ["DeviceFrameCache", "get_frame"]
