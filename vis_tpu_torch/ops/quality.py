"""Image-quality compute: Laplacian sharpness and brightness, host path.

The port's copy of the numpy half of ``vis_tpu.ops.quality``.  The
Laplacian uses the 3x3 stencil [[0,1,0],[1,-4,1],[0,1,0]] with reflect-101
borders, matching cv2.Laplacian(..., CV_64F) exactly on uint8 input
(reference: src/safety/image_quality.py:105-168).  The JAX package's
device variant is not ported yet; ``laplacian_variance(device=True)``
raises instead of quietly running on the host.
"""

from __future__ import annotations

import numpy as np


def laplacian_variance_np(gray: np.ndarray) -> float:
    """Variance of the 3x3 Laplacian response (sharpness proxy), host path."""
    g = gray.astype(np.float64)
    p = np.pad(g, 1, mode="reflect")  # reflect-101: edge pixel not duplicated
    lap = (
        p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4.0 * g
    )
    return float(lap.var())


def mean_brightness_np(gray: np.ndarray) -> float:
    return float(np.mean(gray))


def laplacian_variance(gray: np.ndarray, device: bool = False) -> float:
    """Sharpness metric on the host; the device variant is not ported."""
    if device:
        raise NotImplementedError("the device Laplacian is not ported to the GPU yet")
    return laplacian_variance_np(gray)


__all__ = [
    "laplacian_variance",
    "laplacian_variance_np",
    "mean_brightness_np",
]
