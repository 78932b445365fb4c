"""Workflow state for the inspection pipeline
(reference: src/orchestration/state.py:10-129 — same fields, same
validate_state contract)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, TypedDict, Union


class InspectionState(TypedDict, total=False):
    """Mutable state threaded through the pipeline nodes."""

    # Input
    image_path: Union[str, List[str]]
    context: Dict[str, Any]  # InspectionContext as dict

    # Request tracking
    request_id: str
    start_time: float

    # Model results (stored as dicts for checkpointability)
    inspector_result: Optional[Dict[str, Any]]
    auditor_result: Optional[Dict[str, Any]]

    # Consensus and safety
    consensus: Optional[Dict[str, Any]]
    safety_verdict: Optional[Dict[str, Any]]
    clean_verification: Optional[Dict[str, Any]]

    # Human review
    requires_human_review: bool
    human_decision: Optional[str]  # "approve" | "reject" | "modify"
    human_notes: Optional[str]
    human_review_context: Optional[Dict[str, Any]]

    # Explanation and report
    explanation: Optional[str]
    decision_support: Optional[Dict[str, Any]]
    report_path: Optional[str]

    # Metadata
    processing_time: Optional[float]
    error: Optional[str]
    failure_history: Optional[List[str]]
    has_critical_failure: Optional[bool]
    inspector_retry_count: Optional[int]
    auditor_retry_count: Optional[int]
    image_quality: Optional[Dict[str, Any]]
    low_quality_image: Optional[bool]
    current_step: str


_DEFAULT_REQUIRED = ["image_path", "context", "request_id", "current_step"]


def validate_state(
    state: InspectionState, required_fields: Optional[List[str]] = None
) -> Tuple[bool, Optional[str]]:
    """Precondition check before critical nodes
    (reference state.py:10-89)."""
    if not isinstance(state, dict):
        return False, "State must be a dictionary"

    required = required_fields if required_fields is not None else _DEFAULT_REQUIRED
    missing = [f for f in required if f not in state or state[f] is None]
    if missing:
        return False, f"Missing required fields: {', '.join(missing)}"

    context = state.get("context")
    if context is not None:
        if not isinstance(context, dict):
            return False, "Context must be a dictionary"
        if "criticality" not in context:
            return False, "Missing required context fields: criticality"
        if context["criticality"] not in ("low", "medium", "high"):
            return False, (
                f"Invalid criticality value: {context['criticality']} "
                "(must be 'low', 'medium', or 'high')"
            )

    image_path = state.get("image_path")
    if image_path is not None:
        if not isinstance(image_path, (str, list)):
            return False, "image_path must be a string or list of strings"
        if isinstance(image_path, list) and not all(
            isinstance(p, str) for p in image_path
        ):
            return False, "All image paths in list must be strings"

    for key in ("inspector_result", "auditor_result"):
        result = state.get(key)
        if result is None:
            continue
        if not isinstance(result, dict):
            return False, f"{key} must be a dictionary"
        if result.get("analysis_failed") and not result.get("failure_reason"):
            return False, f"{key} with analysis_failed=True must have failure_reason"

    return True, None


__all__ = ["InspectionState", "validate_state"]
