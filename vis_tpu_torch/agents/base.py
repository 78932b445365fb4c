"""Base agent: inference-backend protocol, robust JSON extraction, and model
output repair.

The parse/fix-up pipeline is the guardrail that turns free-form VLM text into
a schema-valid VLMAnalysisResult, with semantics matching the reference
(reference: src/agents/vlm_inspector.py:142-431, duplicated in
vlm_auditor.py:236-472): fence -> balanced-brace -> slice extraction with a
regex salvage of analysis_reasoning, then field defaults, clean-image
confidence boosting, vague-reasoning false-positive filtering, and
percentage-space bbox normalization/rejection.

The transport difference from the reference: instead of HTTPS clients, agents
talk to an InferenceBackend — an in-process engine whose generate() runs
prefill+decode on the GPU (vis_tpu_torch.serving) or a deterministic mock
(vis_tpu_torch.agents.mock).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Protocol, runtime_checkable

from vis_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__, level="INFO", component="AGENT")


@runtime_checkable
class InferenceBackend(Protocol):
    """Minimal contract every model backend implements."""

    name: str

    def generate(
        self,
        prompt: str,
        image_path: Optional[Path] = None,
        *,
        max_tokens: int = 1024,
        temperature: float = 0.0,
        max_image_dim: int = 2048,
        json_mode: bool = False,
        json_schema: "Optional[str]" = None,
        schema_batched: bool = False,
        min_tokens: "Optional[int]" = None,
    ) -> str:
        ...

    def generate_stream(
        self,
        prompt: str,
        image_path: Optional[Path] = None,
        *,
        max_tokens: int = 1024,
        temperature: float = 0.0,
        max_image_dim: int = 2048,
        json_mode: bool = False,
        json_schema: "Optional[str]" = None,
        schema_batched: bool = False,
        min_tokens: "Optional[int]" = None,
    ) -> Iterator[str]:
        ...

    def health_check(self) -> bool:
        ...


_FENCE_RE = re.compile(r"```(?:json)?\s*([\s\S]*?)```")
_REASONING_RE = re.compile(r'"analysis_reasoning"\s*:\s*"([^"]*(?:\\.[^"]*)*)"', re.DOTALL)
_REASONING_SIMPLE_RE = re.compile(r'"analysis_reasoning"\s*:\s*"([^"]*)"')
_OBJECT_RE = re.compile(r'"object_identified"\s*:\s*"([^"]*)"')

_VAGUE_REASONING_MARKERS = (
    "possible", "might be", "appears to be", "could be", "uncertain", "unclear",
)
_VAGUE_LOCATION_MARKERS = ("somewhere", "various", "multiple", "general", "areas")


def _scan_balanced_json(text: str) -> Optional[str]:
    """Return the longest substring that is a parseable brace-balanced JSON
    object, honoring strings and escapes."""
    best: Optional[str] = None
    best_len = 0
    i = 0
    n = len(text)
    while i < n:
        if text[i] != "{":
            i += 1
            continue
        depth = 0
        in_string = False
        escaped = False
        for j in range(i, n):
            ch = text[j]
            if escaped:
                escaped = False
                continue
            if ch == "\\":
                escaped = True
                continue
            if ch == '"':
                in_string = not in_string
                continue
            if in_string:
                continue
            if ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                if depth == 0:
                    candidate = text[i : j + 1]
                    if len(candidate) > best_len:
                        try:
                            json.loads(candidate)
                            best = candidate
                            best_len = len(candidate)
                        except json.JSONDecodeError:
                            pass
                    break
        i += 1
    return best


def parse_json_robust(text: str) -> Dict[str, Any]:
    """Extract a JSON object from model output; raises ValueError on failure.

    Strategy ladder (reference vlm_inspector.py:142-267):
      1. markdown code fences,
      2. longest balanced-brace object,
      3. naive first-'{' to last-'}' slice,
      4. regex salvage of analysis_reasoning into a partial low-confidence result.
    """
    text = text.strip()

    for match in _FENCE_RE.findall(text):
        try:
            return json.loads(match.strip())
        except json.JSONDecodeError:
            continue

    balanced = _scan_balanced_json(text)
    if balanced is not None:
        try:
            return json.loads(balanced)
        except json.JSONDecodeError:
            pass

    start = text.find("{")
    end = text.rfind("}") + 1
    if start != -1 and end > start:
        try:
            return json.loads(text[start:end])
        except json.JSONDecodeError:
            pass

    if "analysis_reasoning" in text:
        match = _REASONING_RE.search(text) or _REASONING_SIMPLE_RE.search(text)
        if match:
            reasoning = match.group(1).replace('\\"', '"').replace("\\n", "\n")
            logger.warning(
                "JSON parsing failed; salvaged analysis_reasoning into partial result"
            )
            obj_match = _OBJECT_RE.search(text)
            return {
                "analysis_reasoning": reasoning,
                "object_identified": obj_match.group(1) if obj_match else "unknown",
                "defects": [],
                "overall_condition": "uncertain",
                "overall_confidence": "low",
            }

    logger.error(f"JSON parsing failed. Raw text (first 500 chars): {text[:500]}")
    raise ValueError("Failed to parse JSON from model response")


def validate_and_fix_result(
    result: Dict[str, Any], *, boost_clean_confidence: bool = True
) -> Dict[str, Any]:
    """Repair a parsed model result in place and return it.

    Applies (reference vlm_inspector.py:269-431):
    - required-field defaults (unknown/uncertain/low/[]),
    - clean-image confidence boosting (0 defects + "good": low->medium->high),
    - per-defect field defaults and enum coercion,
    - drop low-confidence defects whose reasoning hedges ("might be", ...),
    - bbox normalization: >100 values treated as pixel leakage -> bbox removed;
      out-of-range/oversized (area >50%) -> removed; tiny (<0.05%) flagged and,
      for low-confidence + <0.02%, the whole defect is dropped,
    - drop low-confidence bbox-less defects with vague locations.
    """
    result.setdefault("object_identified", "unknown")
    result.setdefault("overall_condition", "uncertain")
    result.setdefault("overall_confidence", "low")
    result.setdefault("defects", [])

    if result["overall_condition"] not in ("damaged", "good", "uncertain"):
        result["overall_condition"] = "uncertain"
    if result["overall_confidence"] not in ("high", "medium", "low"):
        result["overall_confidence"] = "low"

    if (
        boost_clean_confidence
        and not result["defects"]
        and result["overall_condition"] == "good"
    ):
        if result["overall_confidence"] == "low":
            result["overall_confidence"] = "medium"
            logger.info("Boosted clean-image confidence low -> medium")
        elif result["overall_confidence"] == "medium":
            result["overall_confidence"] = "high"
            logger.info("Boosted clean-image confidence medium -> high")

    fixed_defects = []
    for defect in result["defects"]:
        if not isinstance(defect, dict):
            continue
        defect.setdefault("type", "unspecified")
        defect.setdefault("location", "unspecified")
        defect.setdefault("safety_impact", "MODERATE")
        defect.setdefault("reasoning", "No reasoning provided")
        defect.setdefault("confidence", "low")
        defect.setdefault("recommended_action", "Further inspection recommended")

        if defect["safety_impact"] not in ("CRITICAL", "MODERATE", "COSMETIC"):
            defect["safety_impact"] = "MODERATE"
        if defect["confidence"] not in ("high", "medium", "low"):
            defect["confidence"] = "low"

        reasoning_lower = str(defect.get("reasoning", "")).lower()
        hedged = any(marker in reasoning_lower for marker in _VAGUE_REASONING_MARKERS)
        if defect["confidence"] == "low" and hedged:
            logger.warning(
                f"Dropping hedged low-confidence defect: {defect.get('type')}"
            )
            continue

        skip_defect = False
        bbox = defect.get("bbox")
        if bbox:
            if not isinstance(bbox, dict) or not all(
                k in bbox for k in ("x", "y", "width", "height")
            ):
                defect["bbox"] = None
            else:
                try:
                    x = float(bbox.get("x", 0))
                    y = float(bbox.get("y", 0))
                    w = float(bbox.get("width", 0))
                    h = float(bbox.get("height", 0))
                except (TypeError, ValueError):
                    x = y = w = h = -1.0
                if any(v > 100 for v in (x, y, w, h) if v > 0):
                    # Pixel coordinates leaked despite the percentage contract;
                    # without the model's input resolution the box is unusable.
                    logger.warning(f"Bbox looks pixel-valued, removing: {bbox}")
                    defect["bbox"] = None
                    defect["bbox_approximate"] = True
                elif (
                    x < 0 or x > 100 or y < 0 or y > 100
                    or w <= 0 or w > 100 or h <= 0 or h > 100
                ):
                    logger.warning(f"Bbox out of percentage range, removing: {bbox}")
                    defect["bbox"] = None
                    defect["bbox_approximate"] = True
                elif x + w > 100 or y + h > 100:
                    logger.warning(f"Bbox exceeds image bounds, removing: {bbox}")
                    defect["bbox"] = None
                    defect["bbox_approximate"] = True
                else:
                    area = (w * h) / 100.0
                    if area < 0.05:
                        if defect["confidence"] == "low" and area < 0.02:
                            logger.warning(
                                f"Dropping low-confidence defect with microscopic "
                                f"bbox: {defect.get('type')}"
                            )
                            skip_defect = True
                        else:
                            defect["bbox_approximate"] = True
                    elif area > 50.0:
                        logger.warning(f"Bbox area {area:.1f}% > 50%, removing: {bbox}")
                        defect["bbox"] = None
                        defect["bbox_approximate"] = True
                    else:
                        # Floor tiny extents at 0.1 but never past the image
                        # edge: bumping w for a sliver at x=99.95 would make
                        # x+w exceed 100 and fail BoundingBox validation,
                        # turning one odd box into a whole-analysis failure.
                        cx = max(0.0, min(100.0, x))
                        cy = max(0.0, min(100.0, y))
                        defect["bbox"] = {
                            "x": cx,
                            "y": cy,
                            "width": min(max(0.1, min(100.0, w)), 100.0 - cx),
                            "height": min(max(0.1, min(100.0, h)), 100.0 - cy),
                        }
        if skip_defect:
            continue

        if not defect.get("bbox") and defect["confidence"] == "low":
            location_lower = str(defect.get("location", "")).lower()
            if any(marker in location_lower for marker in _VAGUE_LOCATION_MARKERS):
                logger.warning(
                    f"Dropping low-confidence defect with vague location: "
                    f"{defect.get('type')}"
                )
                continue

        fixed_defects.append(defect)

    result["defects"] = fixed_defects
    return result


class BaseVLMAgent:
    """Common plumbing for inspector/auditor/explainer agents."""

    component = "AGENT"

    def __init__(self, backend: InferenceBackend, model_name: str,
                 temperature: float, max_tokens: int):
        self.backend = backend
        self.model_name = model_name
        self.temperature = temperature
        self.max_tokens = max_tokens
        self.logger = setup_logger(
            f"vis_tpu_torch.agents.{self.component.lower()}", component=self.component
        )

    def _parse_json_robust(self, text: str) -> Dict[str, Any]:
        return parse_json_robust(text)

    def _validate_and_fix_result(self, result: Dict[str, Any]) -> Dict[str, Any]:
        return validate_and_fix_result(result)

    def health_check(self) -> bool:
        try:
            return self.backend.health_check()
        except Exception as exc:
            self.logger.error(f"Health check failed: {exc}")
            return False


__all__ = [
    "InferenceBackend",
    "BaseVLMAgent",
    "parse_json_robust",
    "validate_and_fix_result",
]
