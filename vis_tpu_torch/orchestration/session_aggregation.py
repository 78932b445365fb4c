"""Session-level rollup of per-image inspection results.

Pure functions matching the reference semantics
(reference: src/orchestration/session_aggregation.py:13-118): severity counts,
verdict distribution, and a conservative aggregate verdict where any UNSAFE
image taints the whole session.
"""

from __future__ import annotations

from typing import Any, Dict, List

_EMPTY_SUMMARY = {
    "total_images": 0,
    "completed_images": 0,
    "failed_images": 0,
    "aggregate_verdict": "UNKNOWN",
    "total_defects": 0,
    "critical_defects": 0,
    "moderate_defects": 0,
    "cosmetic_defects": 0,
}


def determine_aggregate_verdict(verdicts: List[str], total_defects: int) -> str:
    """Conservative precedence: UNSAFE > REQUIRES_HUMAN_REVIEW > all-SAFE;
    any other mix falls back to review.  total_defects is accepted for
    reference-signature parity but — exactly like the reference
    (session_aggregation.py:88-113) — does not affect the verdict: an
    all-SAFE session stays SAFE regardless of defect counts (per-image
    gates already weighed them)."""
    if not verdicts:
        return "UNKNOWN"
    if any(v == "UNSAFE" for v in verdicts):
        return "UNSAFE"
    if any(v == "REQUIRES_HUMAN_REVIEW" for v in verdicts):
        return "REQUIRES_HUMAN_REVIEW"
    if all(v == "SAFE" for v in verdicts):
        return "SAFE"
    return "REQUIRES_HUMAN_REVIEW"


def aggregate_session_results(image_results: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Roll up a {image_id: result-dict} map into a session summary."""
    if not image_results:
        return dict(_EMPTY_SUMMARY)

    completed = failed = 0
    total_defects = critical = moderate = cosmetic = 0
    verdicts: List[str] = []

    for result in image_results.values():
        if not result.get("completed", False):
            failed += 1
            continue
        completed += 1
        verdicts.append(result.get("safety_verdict", {}).get("verdict", "UNKNOWN"))
        defects = result.get("consensus", {}).get("combined_defects", [])
        total_defects += len(defects)
        for defect in defects:
            severity = defect.get("safety_impact", "COSMETIC")
            if severity == "CRITICAL":
                critical += 1
            elif severity == "MODERATE":
                moderate += 1
            elif severity == "COSMETIC":
                cosmetic += 1

    return {
        "total_images": len(image_results),
        "completed_images": completed,
        "failed_images": failed,
        "aggregate_verdict": determine_aggregate_verdict(verdicts, total_defects),
        "total_defects": total_defects,
        "critical_defects": critical,
        "moderate_defects": moderate,
        "cosmetic_defects": cosmetic,
        "verdict_distribution": {
            "SAFE": sum(1 for v in verdicts if v == "SAFE"),
            "UNSAFE": sum(1 for v in verdicts if v == "UNSAFE"),
            "REQUIRES_HUMAN_REVIEW": sum(
                1 for v in verdicts if v == "REQUIRES_HUMAN_REVIEW"
            ),
        },
    }


__all__ = ["aggregate_session_results", "determine_aggregate_verdict"]
