"""Image annotation and visualization utilities.

Covers the reference's image helper surface (reference: utils/image_utils.py:
20-739): load/resize/validate, numbered bounding-box markers with dashed
low-confidence boxes, Gaussian defect heatmaps with a JET colormap, side-by-
side comparisons, and verdict status stamps.

These run host-side with numpy/PIL — they feed reports and the UI, not the
model.  The model-input hot path (decode/resize/normalize/patchify) is the
separate device pipeline in vis_tpu_torch.ops.preprocess.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw, ImageFont

from vis_tpu_torch.utils.config import config
from vis_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__, level="INFO", component="IMAGE_UTILS")

SEVERITY_COLORS = {
    "CRITICAL": (220, 38, 38),   # red
    "MODERATE": (245, 158, 11),  # amber
    "COSMETIC": (59, 130, 246),  # blue
}
_DEFAULT_COLOR = (107, 114, 128)  # gray

VERDICT_COLORS = {
    "SAFE": (22, 163, 74),
    "UNSAFE": (220, 38, 38),
    "REQUIRES_HUMAN_REVIEW": (245, 158, 11),
}


def load_image(image_path) -> Image.Image:
    """Open an image as RGB (reference image_utils.py:20).

    Rides the shared frame cache: the report overlays (heatmap + bbox
    panels) reuse the decode already paid by the quality gate / engines.
    Returns a fresh Image each call, so callers may draw on it freely."""
    from vis_tpu_torch.ops.frame_cache import get_frame

    return Image.fromarray(get_frame(image_path))


def resize_image(
    image: Image.Image, max_dimension: Optional[int] = None
) -> Image.Image:
    """Downscale so max(w, h) <= max_dimension, preserving aspect (LANCZOS),
    never upscaling (reference image_utils.py:46)."""
    limit = max_dimension or config.max_image_dimension
    if max(image.size) <= limit:
        return image
    ratio = limit / max(image.size)
    new_size = (max(1, round(image.width * ratio)), max(1, round(image.height * ratio)))
    return image.resize(new_size, Image.LANCZOS)


def get_image_info(image_path) -> Dict[str, Any]:
    """Basic metadata (reference image_utils.py:81)."""
    path = Path(image_path)
    with Image.open(path) as im:
        return {
            "path": str(path),
            "filename": path.name,
            "format": im.format,
            "width": im.width,
            "height": im.height,
            "mode": im.mode,
            "size_kb": round(path.stat().st_size / 1024, 1),
        }


def validate_image(image_path) -> Tuple[bool, Optional[str]]:
    """Openability + size/extension checks (reference image_utils.py:104)."""
    path = Path(image_path)
    if not path.exists():
        return False, f"File not found: {path}"
    ext = path.suffix.lower().lstrip(".")
    if ext not in config.allowed_extensions_list:
        return False, f"Unsupported extension: {ext}"
    size = path.stat().st_size
    if size == 0:
        return False, "File is empty"
    size_mb = size / (1024 * 1024)
    if size_mb > config.max_file_size_mb:
        return False, f"File too large: {size_mb:.1f}MB"
    try:
        with Image.open(path) as im:
            im.verify()
    except Exception as exc:
        return False, f"Corrupt image: {exc}"
    return True, None


def _bbox_to_pixels(
    bbox: Dict[str, float], width: int, height: int
) -> Tuple[int, int, int, int]:
    """Percentage-space bbox -> pixel (x0, y0, x1, y1)."""
    x0 = int(round(bbox["x"] / 100.0 * width))
    y0 = int(round(bbox["y"] / 100.0 * height))
    x1 = int(round((bbox["x"] + bbox["width"]) / 100.0 * width))
    y1 = int(round((bbox["y"] + bbox["height"]) / 100.0 * height))
    return (
        max(0, min(width - 1, x0)),
        max(0, min(height - 1, y0)),
        max(1, min(width, x1)),
        max(1, min(height, y1)),
    )


def _load_font(size: int):
    try:
        return ImageFont.truetype(
            "/usr/share/fonts/truetype/dejavu/DejaVuSans-Bold.ttf", size
        )
    except Exception:
        return ImageFont.load_default()


def _dashed_rectangle(draw: ImageDraw.ImageDraw, box, color, width=2, dash=8):
    """Draw a dashed rectangle (PIL has no native dashing)."""
    x0, y0, x1, y1 = box
    for edge in (
        ((x0, y0), (x1, y0)),
        ((x1, y0), (x1, y1)),
        ((x1, y1), (x0, y1)),
        ((x0, y1), (x0, y0)),
    ):
        (ax, ay), (bx, by) = edge
        length = max(abs(bx - ax), abs(by - ay))
        if length == 0:
            continue
        steps = max(1, int(length // dash))
        for i in range(0, steps, 2):
            t0 = i / steps
            t1 = min(1.0, (i + 1) / steps)
            draw.line(
                [
                    (ax + (bx - ax) * t0, ay + (by - ay) * t0),
                    (ax + (bx - ax) * t1, ay + (by - ay) * t1),
                ],
                fill=color,
                width=width,
            )


def draw_bounding_boxes(
    image_path,
    defects: List[Dict[str, Any]],
    output_path=None,
) -> Image.Image:
    """Annotate defects: severity-colored boxes (dashed when low-confidence)
    with numbered circular markers (reference image_utils.py:148)."""
    image = load_image(image_path)
    draw = ImageDraw.Draw(image)
    marker_radius = max(10, image.width // 60)
    font = _load_font(marker_radius)
    line_w = max(2, image.width // 400)

    for idx, defect in enumerate(defects, start=1):
        bbox = defect.get("bbox")
        if not bbox:
            continue
        color = SEVERITY_COLORS.get(defect.get("safety_impact", ""), _DEFAULT_COLOR)
        box = _bbox_to_pixels(bbox, image.width, image.height)
        if defect.get("confidence") == "low":
            _dashed_rectangle(draw, box, color, width=line_w)
        else:
            draw.rectangle(box, outline=color, width=line_w)
        # Numbered marker at the top-left corner of the box.
        cx, cy = box[0], box[1]
        draw.ellipse(
            (cx - marker_radius, cy - marker_radius,
             cx + marker_radius, cy + marker_radius),
            fill=color,
        )
        label = str(idx)
        tb = draw.textbbox((0, 0), label, font=font)
        draw.text(
            (cx - (tb[2] - tb[0]) / 2, cy - (tb[3] - tb[1]) / 2 - tb[1]),
            label,
            fill=(255, 255, 255),
            font=font,
        )

    if output_path is not None:
        image.save(output_path)
    return image


# Long-side cap for the coarse Gaussian-field grid used by
# create_heatmap_overlay.  512 keeps the smallest Gaussian (sigma=4 px at
# full resolution) above ~1 coarse pixel for images up to ~2K, so the
# bilinear upsample back to full resolution is visually lossless.
_HEATMAP_FIELD_RES = 512


def _jet_colormap(values: np.ndarray) -> np.ndarray:
    """Map [0,1] -> JET RGB (like cv2.COLORMAP_JET), vectorized."""
    v = np.clip(values, 0.0, 1.0)
    four = 4.0 * v
    r = np.clip(np.minimum(four - 1.5, -four + 4.5), 0, 1)
    g = np.clip(np.minimum(four - 0.5, -four + 3.5), 0, 1)
    b = np.clip(np.minimum(four + 0.5, -four + 2.5), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def create_heatmap_overlay(
    image_path,
    defects: List[Dict[str, Any]],
    output_path=None,
    alpha: float = 0.45,
) -> Image.Image:
    """Gaussian severity heatmap composited over the image
    (reference image_utils.py:320).

    Each defect with a bbox contributes an anisotropic Gaussian centered on
    its box, weighted by severity; the field is normalized, JET-mapped, and
    alpha-blended where intensity is significant.
    """
    image = load_image(image_path)
    w, h = image.width, image.height
    # The Gaussian field is smooth by construction (sigma >= 4 px), so
    # evaluate it on a coarse grid (long side <= _HEATMAP_FIELD_RES) and
    # bilinearly upsample: visually identical, but per-defect work is
    # O(coarse grid) instead of O(pixels) — ~25x less at 1080p, which is
    # seconds of host time per report on a 1-vCPU serving host.
    scale = max(1.0, float(max(w, h)) / _HEATMAP_FIELD_RES)
    fw = max(1, int(round(w / scale)))
    fh = max(1, int(round(h / scale)))
    field = np.zeros((fh, fw), dtype=np.float32)

    severity_weight = {"CRITICAL": 1.0, "MODERATE": 0.7, "COSMETIC": 0.4}
    # Coarse-pixel centers in full-resolution coordinates.
    ys = (np.arange(fh, dtype=np.float32)[:, None] + 0.5) * (h / fh)
    xs = (np.arange(fw, dtype=np.float32)[None, :] + 0.5) * (w / fw)

    any_blob = False
    for defect in defects:
        bbox = defect.get("bbox")
        if not bbox:
            continue
        any_blob = True
        x0, y0, x1, y1 = _bbox_to_pixels(bbox, w, h)
        cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
        sx = max((x1 - x0) / 2.0, 4.0)
        sy = max((y1 - y0) / 2.0, 4.0)
        weight = severity_weight.get(defect.get("safety_impact", ""), 0.5)
        field += weight * np.exp(
            -(((xs - cx) ** 2) / (2 * sx ** 2) + ((ys - cy) ** 2) / (2 * sy ** 2))
        )

    if not any_blob:
        if output_path is not None:
            image.save(output_path)
        return image

    field /= field.max()
    if (fh, fw) != (h, w):
        field = np.asarray(
            Image.fromarray(field, mode="F").resize((w, h), Image.BILINEAR),
            dtype=np.float32,
        )
    colored = _jet_colormap(field)
    base = np.asarray(image, dtype=np.float32)
    mask = (field > 0.05).astype(np.float32)[..., None] * alpha * field[..., None]
    blended = base * (1 - mask) + colored.astype(np.float32) * mask
    result = Image.fromarray(np.clip(blended, 0, 255).astype(np.uint8))

    if output_path is not None:
        result.save(output_path)
    return result


def create_side_by_side_comparison(
    image_path,
    defects: List[Dict[str, Any]],
    output_path=None,
) -> Image.Image:
    """Original | heatmap | annotated triptych (reference image_utils.py:608)."""
    original = load_image(image_path)
    heatmap = create_heatmap_overlay(image_path, defects)
    annotated = draw_bounding_boxes(image_path, defects)
    gap = 8
    canvas = Image.new(
        "RGB",
        (original.width * 3 + gap * 2, original.height),
        (255, 255, 255),
    )
    for i, im in enumerate((original, heatmap, annotated)):
        canvas.paste(im, (i * (original.width + gap), 0))
    if output_path is not None:
        canvas.save(output_path)
    return canvas


def create_status_stamp(
    verdict: str, size: Tuple[int, int] = (360, 110)
) -> Image.Image:
    """Rubber-stamp style verdict badge (reference image_utils.py:689)."""
    color = VERDICT_COLORS.get(verdict, _DEFAULT_COLOR)
    img = Image.new("RGBA", size, (0, 0, 0, 0))
    draw = ImageDraw.Draw(img)
    border = 6
    draw.rounded_rectangle(
        (border, border, size[0] - border, size[1] - border),
        radius=14,
        outline=color,
        width=border,
    )
    label = verdict.replace("_", " ")
    font_size = size[1] // 3
    font = _load_font(font_size)
    tb = draw.textbbox((0, 0), label, font=font)
    while tb[2] - tb[0] > size[0] - 4 * border and font_size > 8:
        font_size -= 2
        font = _load_font(font_size)
        tb = draw.textbbox((0, 0), label, font=font)
    draw.text(
        ((size[0] - (tb[2] - tb[0])) / 2, (size[1] - (tb[3] - tb[1])) / 2 - tb[1]),
        label,
        fill=color,
        font=font,
    )
    return img


__all__ = [
    "load_image",
    "resize_image",
    "get_image_info",
    "validate_image",
    "draw_bounding_boxes",
    "create_heatmap_overlay",
    "create_side_by_side_comparison",
    "create_status_stamp",
    "SEVERITY_COLORS",
    "VERDICT_COLORS",
]
