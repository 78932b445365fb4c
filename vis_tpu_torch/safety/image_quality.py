"""Image-quality gate: sharpness / brightness / resolution scoring.

Same thresholds and weighted scoring as the reference
(reference: src/safety/image_quality.py:18-186): Laplacian-variance sharpness
(threshold 100), mean brightness window 30-220, resolution score capped at
2MP; overall = 0.4*sharpness + 0.3*brightness + 0.3*resolution, pass >= 0.6.
The Laplacian itself runs through vis_tpu_torch.ops.quality (host path).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np

from vis_tpu_torch.ops.quality import laplacian_variance, mean_brightness_np
from vis_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__, level="INFO", component="IMAGE_QUALITY")

MIN_SHARPNESS = 100.0      # Laplacian variance below this is blurry
MIN_BRIGHTNESS = 30.0      # mean pixel value (0-255)
MAX_BRIGHTNESS = 220.0
MIN_RESOLUTION = 100       # min(width, height) in pixels
MIN_PIXELS = 10_000
FULL_SCORE_PIXELS = 2_000_000.0
PASS_THRESHOLD = 0.6

# BT.601 luma weights used by OpenCV's BGR2GRAY (and PIL's 'L' mode).
_LUMA = np.array([0.299, 0.587, 0.114])


def _load_gray(image_path: Path) -> np.ndarray:
    """Load an image and convert to uint8 grayscale with BT.601 weights,
    rounding to nearest (OpenCV-compatible).

    The quality gate is the pipeline's FIRST touch of the upload; loading
    through the shared frame cache means the dual-VLM node that follows
    finds the decoded frame hot.  (The JAX package also prefetches the
    device copy here; the port's engines copy it on first use.)"""
    from vis_tpu_torch.ops import frame_cache

    rgb = frame_cache.get_frame(image_path).astype(np.float64)
    gray = rgb @ _LUMA
    return np.clip(np.rint(gray), 0, 255).astype(np.uint8)


class ImageQualityAssessment:
    """Scores a single image; see module docstring for the contract."""

    def __init__(self, device: bool = False):
        self.device = device

    def assess_quality(self, image_path: Path) -> Dict[str, Any]:
        try:
            try:
                gray = _load_gray(Path(image_path))
            except Exception:
                return self._failed(f"Failed to load image: {image_path}")

            height, width = gray.shape
            total_pixels = width * height

            lap_var = laplacian_variance(gray, device=self.device)
            sharpness_score = self._sharpness_score(lap_var)
            brightness_score, mean_brightness = self._brightness_score(gray)
            resolution_score = self._resolution_score(width, height, total_pixels)

            overall = (
                0.4 * sharpness_score + 0.3 * brightness_score + 0.3 * resolution_score
            )
            passed = overall >= PASS_THRESHOLD

            result = {
                "quality_score": round(overall, 3),
                "quality_passed": passed,
                "sharpness": {
                    "score": round(sharpness_score, 3),
                    "laplacian_variance": lap_var,
                    "passed": sharpness_score >= PASS_THRESHOLD,
                },
                "brightness": {
                    "score": round(brightness_score, 3),
                    "mean_value": round(mean_brightness, 1),
                    "passed": brightness_score >= PASS_THRESHOLD,
                },
                "resolution": {
                    "score": round(resolution_score, 3),
                    "width": width,
                    "height": height,
                    "total_pixels": total_pixels,
                    "passed": resolution_score >= PASS_THRESHOLD,
                },
                "image_path": str(image_path),
            }
            logger.info(
                f"Image quality: score={overall:.2f} sharp={sharpness_score:.2f} "
                f"bright={brightness_score:.2f} res={resolution_score:.2f}"
            )
            return result
        except Exception as exc:
            logger.error(f"Image quality assessment failed: {exc}", exc_info=True)
            return self._failed(f"Assessment error: {exc}")

    @staticmethod
    def _sharpness_score(lap_var: float) -> float:
        """<100 scales linearly into [0, 0.5); above, 0.5 + (v-100)/400 capped at 1."""
        if lap_var < MIN_SHARPNESS:
            return lap_var / MIN_SHARPNESS * 0.5
        return min(1.0, 0.5 + (lap_var - MIN_SHARPNESS) / 400.0)

    @staticmethod
    def _brightness_score(gray: np.ndarray) -> Tuple[float, float]:
        mean_brightness = mean_brightness_np(gray)
        if MIN_BRIGHTNESS <= mean_brightness <= MAX_BRIGHTNESS:
            center = (MIN_BRIGHTNESS + MAX_BRIGHTNESS) / 2
            max_distance = (MAX_BRIGHTNESS - MIN_BRIGHTNESS) / 2
            score = 1.0 - (abs(mean_brightness - center) / max_distance) * 0.3
        elif mean_brightness < MIN_BRIGHTNESS:
            score = max(0.0, mean_brightness / MIN_BRIGHTNESS * 0.6)
        else:
            excess = mean_brightness - MAX_BRIGHTNESS
            score = max(0.0, 1.0 - (excess / (255 - MAX_BRIGHTNESS)) * 0.8)
        return score, mean_brightness

    @staticmethod
    def _resolution_score(width: int, height: int, total_pixels: int) -> float:
        # Parity note: the reference's exact scoring (image_quality.py:151-
        # 167) including its discontinuity — a 99x101 image scores 0.3
        # while 105x100 scores ~0.005, and the MIN_PIXELS branch is
        # unreachable (min-dim >= 100 implies >= 10k pixels).  Thresholds
        # are part of the bit-exact quality-gate contract.
        if min(width, height) < MIN_RESOLUTION:
            return 0.3
        if total_pixels < MIN_PIXELS:
            return 0.5
        return min(1.0, total_pixels / FULL_SCORE_PIXELS)

    @staticmethod
    def _failed(reason: str) -> Dict[str, Any]:
        return {
            "quality_score": 0.0,
            "quality_passed": False,
            "sharpness": {"score": 0.0, "passed": False},
            "brightness": {"score": 0.0, "passed": False},
            "resolution": {"score": 0.0, "passed": False},
            "error": reason,
        }


def assess_image_quality(image_path: Path, device: bool = False) -> Dict[str, Any]:
    """Assess quality of one image (reference image_quality.py:182)."""
    return ImageQualityAssessment(device=device).assess_quality(image_path)


__all__ = ["ImageQualityAssessment", "assess_image_quality", "PASS_THRESHOLD"]
