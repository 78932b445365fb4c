"""Seeded inspection photos: u8 RGB arrays and the PNG files the program
reads.

A photo is a smooth lit surface (a colour gradient over a coarse random
texture) with a few dark streaks and spots standing in for defects, at a
camera's size.  The program resizes it to its served size on the device;
the reference resizes ``photo_array(spec)`` with its own copy of the rule
(``families/qwen2_5_vl.py``).  PNG is lossless: the program decodes exactly
``photo_array(spec)``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict

import numpy as np


def photo_array(spec: Dict[str, Any]) -> np.ndarray:
    h, w = int(spec["height"]), int(spec["width"])
    rng = np.random.default_rng([int(spec["seed"]) & 0xFFFFFFFF, int(spec["seed"]) >> 32,
                                 int(spec["index"])])
    yy = (np.arange(h, dtype=np.float32) / h)[:, None, None]
    xx = (np.arange(w, dtype=np.float32) / w)[None, :, None]
    base = rng.uniform(60, 200, size=3).astype(np.float32)
    tilt = rng.uniform(-60, 60, size=(2, 3)).astype(np.float32)
    img = base + yy * tilt[0] + xx * tilt[1]
    coarse = rng.normal(0, 12, size=(h // 28 + 1, w // 28 + 1, 3)).astype(np.float32)
    img += np.repeat(np.repeat(coarse, 28, axis=0), 28, axis=1)[:h, :w]
    for _ in range(int(rng.integers(1, 5))):
        y0, x0 = int(rng.integers(0, h - 8)), int(rng.integers(0, w - 8))
        length = int(rng.integers(20, max(21, min(h, w) // 2)))
        if rng.random() < 0.5:
            img[y0:y0 + 3, x0:x0 + length] *= 0.35
        else:
            img[y0:y0 + length, x0:x0 + 3] *= 0.35
    return np.clip(img, 0, 255).astype(np.uint8)


def write_photo(spec: Dict[str, Any], directory: Path) -> Path:
    """The photo's PNG, named by everything that makes it (runs of other
    seeds may share the directory), written whole before it appears."""
    from PIL import Image

    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"photo_{spec['seed']}_{spec['index']}_{spec['height']}x{spec['width']}.png"
    part = path.with_name(f"{path.name}.{os.getpid()}.part")
    Image.fromarray(photo_array(spec)).save(part, format="PNG", compress_level=1)
    os.replace(part, path)
    return path


__all__ = ["photo_array", "write_photo"]
