"""Pipeline node functions (reference: src/orchestration/nodes.py:50-793).

Each node takes and returns InspectionState.  Node semantics match the
reference: one retry with capped exponential backoff per model agent, agents
degrade to analysis_failed results rather than raising, clean-verification
double-checks zero-defect verdicts, explanation is section-validated with
structured-data fallback, then DB save, then finalize (+PDF).

The main structural change for on-device serving: `run_inspector_and_auditor` executes both
model calls concurrently (the reference ran them sequentially even though
they are independent; see SURVEY.md §2 item 16 and reference graph.py:82-83).
"""

from __future__ import annotations

import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, List, Union

from vis_tpu_torch.agents import get_auditor, get_explainer, get_inspector
from vis_tpu_torch.database import InspectionRepository
from vis_tpu_torch.orchestration.state import InspectionState, validate_state
from vis_tpu_torch.safety import analyze_consensus, evaluate_safety
from vis_tpu_torch.safety.image_quality import assess_image_quality
from vis_tpu_torch.schemas.models import (
    ConsensusResult,
    InspectionContext,
    VLMAnalysisResult,
)
from vis_tpu_torch.utils.config import config
from vis_tpu_torch.utils.logger import set_request_id, setup_logger, span

logger = setup_logger(__name__, level="INFO", component="WORKFLOW")

MAX_AGENT_RETRIES = 1

# Inspector and auditor run concurrently and may both append failures; their
# read-modify-write on shared state keys must be serialized.
import threading

_state_mutation_lock = threading.Lock()

_CRITICALITY_ORDER = {"low": 0, "medium": 1, "high": 2}


def _as_path_list(image_path: Union[str, List[str]]) -> List[str]:
    if isinstance(image_path, str):
        return [image_path]
    if isinstance(image_path, list):
        return image_path
    raise ValueError(f"Invalid image_path type: {type(image_path)}")


def _backoff_delay(retry_count: int) -> float:
    return min(2.0 ** retry_count, 10.0)


def _failed_result(stage: str, error: str) -> VLMAnalysisResult:
    return VLMAnalysisResult(
        object_identified="unknown",
        overall_condition="uncertain",
        defects=[],
        overall_confidence="low",
        analysis_reasoning=f"{stage} failed after retries: {error}",
        analysis_failed=True,
        failure_reason=error,
    )


def initialize_inspection(state: InspectionState) -> InspectionState:
    """Seed request ID, timing, and counters."""
    request_id = state.get("request_id") or str(uuid.uuid4())[:8]
    set_request_id(request_id)

    paths = _as_path_list(state["image_path"])
    desc = paths[0] if len(paths) == 1 else f"{len(paths)} images"
    logger.info(f"Starting inspection {request_id}: {desc} "
                f"(criticality={state['context'].get('criticality')}, "
                f"domain={state['context'].get('domain')})")

    state["request_id"] = request_id
    state["start_time"] = time.time()
    state["current_step"] = "initialized"
    state["requires_human_review"] = False
    state["failure_history"] = []
    state["has_critical_failure"] = False
    state["inspector_retry_count"] = 0
    state["auditor_retry_count"] = 0
    return state


def check_image_quality(state: InspectionState) -> InspectionState:
    """Non-blocking quality gate; poor quality flags downstream gates."""
    state["current_step"] = "quality_check"
    try:
        paths = _as_path_list(state["image_path"])
        quality = assess_image_quality(Path(paths[0]))
        state["image_quality"] = quality
        if not quality.get("quality_passed", False):
            logger.warning(
                f"Image quality below threshold "
                f"(score={quality.get('quality_score', 0.0):.2f}); "
                "analysis may be less reliable"
            )
            state["low_quality_image"] = True
    except Exception as exc:
        logger.error(f"Image quality check failed: {exc}", exc_info=True)
        state["image_quality"] = {"quality_passed": False, "error": str(exc)}
    return state


def _run_agent_with_retry(
    state: InspectionState,
    *,
    stage: str,
    retry_key: str,
    call: Callable[[Path, InspectionContext], VLMAnalysisResult],
) -> VLMAnalysisResult:
    """Shared retry loop for inspector/auditor (reference nodes.py:115-296)."""
    retry_count = state.get(retry_key, 0) or 0
    # Snapshot under the lock: the sibling node's _apply_inferred_criticality
    # may replace state["context"] concurrently (run_inspector_and_auditor
    # overlaps both nodes), and **-unpacking a dict that mutates mid-iteration
    # raises RuntimeError.
    with _state_mutation_lock:
        context_snapshot = dict(state["context"])
    context = InspectionContext(**context_snapshot)
    image_path = Path(_as_path_list(state["image_path"])[0])

    while True:
        try:
            if retry_count > 0:
                delay = _backoff_delay(retry_count - 1)
                logger.info(
                    f"Retrying {stage} (attempt {retry_count + 1}/"
                    f"{MAX_AGENT_RETRIES + 1}) after {delay:.1f}s"
                )
                time.sleep(delay)
            result = call(image_path, context)
            if result.analysis_failed:
                raise RuntimeError(result.failure_reason or f"{stage} failed")
            return result
        except Exception as exc:
            logger.warning(f"{stage} attempt {retry_count + 1} failed: {exc}")
            if retry_count < MAX_AGENT_RETRIES:
                retry_count += 1
                state[retry_key] = retry_count
                continue
            error_msg = f"{stage} failed after {retry_count + 1} attempt(s): {exc}"
            logger.error(error_msg)
            with _state_mutation_lock:
                state["error"] = error_msg
                state["failure_history"] = (
                    (state.get("failure_history") or []) + [error_msg]
                )
                state["has_critical_failure"] = True
            return _failed_result(stage, error_msg)


def _apply_inferred_criticality(state: InspectionState, result: VLMAnalysisResult) -> None:
    """Upgrade user criticality when the model infers a higher one
    (reference nodes.py:187-206)."""
    if not result.inferred_criticality:
        return
    user_level = state["context"].get("criticality", "medium")
    inferred = result.inferred_criticality
    if inferred == user_level:
        return
    if _CRITICALITY_ORDER.get(inferred, 1) > _CRITICALITY_ORDER.get(user_level, 1):
        logger.warning(
            f"Upgrading criticality '{user_level}' -> '{inferred}' per model "
            f"inference: {result.inferred_criticality_reasoning}"
        )
        # Replace the dict atomically (under the shared lock) instead of
        # inserting keys in place: the auditor thread may be snapshotting
        # state["context"] at this moment (run_inspector_and_auditor).
        with _state_mutation_lock:
            ctx = dict(state["context"])
            ctx["criticality"] = inferred
            ctx["criticality_upgraded"] = True
            ctx["original_criticality"] = user_level
            ctx["upgrade_reason"] = result.inferred_criticality_reasoning
            state["context"] = ctx


def run_inspector(state: InspectionState) -> InspectionState:
    state["current_step"] = "inspector_analysis"
    inspector = get_inspector()
    with span("inspector", logger):
        result = _run_agent_with_retry(
            state,
            stage="Inspector",
            retry_key="inspector_retry_count",
            call=inspector.analyze,
        )
    state["inspector_result"] = result.model_dump()
    _apply_inferred_criticality(state, result)
    if not result.analysis_failed:
        logger.info(f"Inspector found {len(result.defects)} defects")
    return state


def run_auditor(state: InspectionState) -> InspectionState:
    state["current_step"] = "auditor_verification"
    auditor = get_auditor()
    inspector_result = (
        VLMAnalysisResult(**state["inspector_result"])
        if state.get("inspector_result")
        else None
    )
    with span("auditor", logger):
        result = _run_agent_with_retry(
            state,
            stage="Auditor",
            retry_key="auditor_retry_count",
            call=lambda p, c: auditor.verify(p, c, inspector_result),
        )
    state["auditor_result"] = result.model_dump()
    if not result.analysis_failed:
        logger.info(f"Auditor found {len(result.defects)} defects")
    return state


def run_inspector_and_auditor(state: InspectionState) -> InspectionState:
    """Concurrent dual-model fan-out — the models are independent by design,
    so their device calls overlap (the replacement for the reference's
    sequential inspector -> auditor chain)."""
    if config.max_concurrent_calls <= 1:
        run_inspector(state)
        return run_auditor(state)

    state["current_step"] = "dual_vlm_analysis"
    with ThreadPoolExecutor(max_workers=2) as pool:
        f_inspector = pool.submit(run_inspector, state)
        f_auditor = pool.submit(run_auditor, state)
        f_inspector.result()
        f_auditor.result()
    return state


def analyze_consensus_node(state: InspectionState) -> InspectionState:
    state["current_step"] = "consensus_analysis"
    try:
        ok, err = validate_state(
            state, required_fields=["inspector_result", "auditor_result"]
        )
        if not ok:
            raise ValueError(f"State validation failed: {err}")

        inspector_result = VLMAnalysisResult(**state["inspector_result"])
        auditor_result = VLMAnalysisResult(**state["auditor_result"])

        if inspector_result.analysis_failed or auditor_result.analysis_failed:
            failures = []
            if inspector_result.analysis_failed:
                failures.append(f"Inspector: {inspector_result.failure_reason}")
            if auditor_result.analysis_failed:
                failures.append(f"Auditor: {auditor_result.failure_reason}")
            summary = "; ".join(failures)
            logger.error(f"Critical failure detected: {summary}")
            state["error"] = f"Analysis failures: {summary}"
            state["has_critical_failure"] = True
            # Consensus still runs so Gate 0 sees the failure downstream.

        consensus = analyze_consensus(inspector_result, auditor_result)
        state["consensus"] = consensus.model_dump()
    except Exception as exc:
        logger.error(f"Consensus analysis failed: {exc}", exc_info=True)
        msg = f"Consensus failed: {exc}"
        state["error"] = msg
        state["failure_history"] = (state.get("failure_history") or []) + [msg]
        state["has_critical_failure"] = True
    return state


def evaluate_safety_node(state: InspectionState) -> InspectionState:
    state["current_step"] = "safety_evaluation"
    try:
        ok, err = validate_state(state, required_fields=["context", "consensus"])
        if not ok:
            raise ValueError(f"State validation failed: {err}")

        context = InspectionContext(**state["context"])
        consensus = ConsensusResult(**state["consensus"])
        verdict = evaluate_safety(consensus, context)

        state["safety_verdict"] = verdict.model_dump()
        state["requires_human_review"] = verdict.requires_human
        if verdict.errors:
            state["failure_history"] = (
                (state.get("failure_history") or []) + verdict.errors
            )
        logger.info(
            f"Safety verdict: {verdict.verdict} "
            f"(human={verdict.requires_human}, gates={verdict.triggered_gates})"
        )
    except Exception as exc:
        logger.error(f"Safety evaluation failed: {exc}", exc_info=True)
        msg = f"Safety evaluation failed: {exc}"
        state["error"] = msg
        state["failure_history"] = (state.get("failure_history") or []) + [msg]
        state["has_critical_failure"] = True
    return state


def human_review_node(state: InspectionState) -> InspectionState:
    """Non-blocking review flag for UI display (reference nodes.py:396-426)."""
    state["current_step"] = "flagged_for_review"
    verdict = state.get("safety_verdict") or {}
    consensus = state.get("consensus") or {}
    defects = consensus.get("combined_defects", [])
    state["human_review_context"] = {
        "type": "human_review_recommended",
        "reason": verdict.get("reason", "Clean verification failed or high criticality"),
        "verdict": verdict.get("verdict", "UNKNOWN"),
        "defect_count": len(defects),
        "models_agree": consensus.get("models_agree", False),
        "agreement_score": consensus.get("agreement_score", 0),
        "message": (
            "Human review is recommended. Inspection will complete and results "
            "will be available for review."
        ),
    }
    return state


def clean_verification_node(state: InspectionState) -> InspectionState:
    """Second-order check on zero-defect results (reference nodes.py:429-554):
    dual-HIGH confidence + agreement > 0.8 + no errors + acceptable quality.
    Can escalate SAFE -> REQUIRES_HUMAN_REVIEW only when quality < 0.3 AND
    agreement < 0.9; otherwise failures just flag an optional review."""
    state["current_step"] = "clean_verification"
    try:
        inspector_result = VLMAnalysisResult(**state["inspector_result"])
        auditor_result = VLMAnalysisResult(**state["auditor_result"])
        consensus = ConsensusResult(**state["consensus"])

        defect_count = len(consensus.combined_defects)
        if defect_count != 0:
            state["clean_verification"] = {
                "verified": False,
                "reason": "Not applicable - defects found",
                "defect_count": defect_count,
            }
            return state

        ins_conf = inspector_result.overall_confidence
        aud_conf = auditor_result.overall_confidence
        agreement = consensus.agreement_score

        both_high = ins_conf == "high" and aud_conf == "high"
        high_agreement = agreement > 0.8
        no_errors = not (
            inspector_result.analysis_failed or auditor_result.analysis_failed
        )

        quality = state.get("image_quality") or {}
        quality_passed = quality.get("quality_passed", True)
        quality_score = quality.get("quality_score", 1.0)
        very_poor_quality = quality_score < 0.3

        verified = (
            both_high
            and high_agreement
            and no_errors
            and (quality_passed or (agreement > 0.9 and not very_poor_quality))
        )

        if verified:
            state["clean_verification"] = {
                "verified": True,
                "reason": (
                    "All verification criteria met: high confidence, high "
                    "agreement, no errors, good quality"
                ),
            }
            return state

        reasons = []
        if not both_high:
            reasons.append(
                f"confidence not high (Inspector: {ins_conf}, Auditor: {aud_conf})"
            )
        if not high_agreement:
            reasons.append(f"agreement score too low ({agreement:.2f}, required >0.8)")
        if not no_errors:
            reasons.append("analysis errors detected")
        if not quality_passed:
            reasons.append("image quality below threshold")
        logger.warning(f"Clean verification FAILED: {', '.join(reasons)}")
        state["clean_verification"] = {
            "verified": False,
            "reason": f"Verification failed: {', '.join(reasons)}",
            "details": {
                "inspector_confidence": ins_conf,
                "auditor_confidence": aud_conf,
                "agreement_score": agreement,
                "has_errors": not no_errors,
                "quality_passed": quality_passed,
            },
        }

        verdict = state.get("safety_verdict") or {}
        if verdict.get("verdict") == "SAFE":
            if very_poor_quality and agreement < 0.9:
                logger.warning(
                    "Escalating SAFE -> REQUIRES_HUMAN_REVIEW: very poor quality "
                    "with sub-0.9 agreement"
                )
                verdict["verdict"] = "REQUIRES_HUMAN_REVIEW"
                verdict["requires_human"] = True
                verdict["reason"] = (
                    f"Clean verification failed: {', '.join(reasons)}. "
                    "Conservative review required."
                )
                state["safety_verdict"] = verdict
                state["requires_human_review"] = True
            else:
                state["requires_human_review"] = True
                verdict["review_note"] = (
                    f"Optional review recommended: {', '.join(reasons)}"
                )
                state["safety_verdict"] = verdict
    except Exception as exc:
        logger.error(f"Clean verification failed: {exc}", exc_info=True)
        state["clean_verification"] = {
            "verified": False,
            "reason": f"Verification error: {exc}",
        }
    return state


def generate_explanation(state: InspectionState) -> InspectionState:
    """Narrate findings; validate sections, synthesize fallbacks
    (reference nodes.py:557-670)."""
    state["current_step"] = "generating_explanation"
    try:
        inspector_result = VLMAnalysisResult(**state["inspector_result"])
        auditor_result = VLMAnalysisResult(**state["auditor_result"])
        consensus = state["consensus"]
        verdict = state["safety_verdict"]

        explainer = get_explainer()
        # The three report decodes (narration, counterfactual, decision
        # support) are independent; the bundle submits them concurrently so
        # the engine's continuous-batching scheduler shares every decode
        # step's weight reads (~2x on this node vs the sequential calls the
        # reference makes, reference nodes.py:557-668).
        with span("explainer", logger):
            explanation, counterfactual, decision_support = (
                explainer.generate_report_bundle(
                    inspector_result, auditor_result, consensus, verdict
                )
            )

        explanation_lower = explanation.lower()
        has_summary = any(
            kw in explanation_lower
            for kw in ("executive summary", "summary", "overview")
        )
        has_recommendation = any(
            kw in explanation_lower
            for kw in ("final recommendation", "recommendation", "verdict",
                       "action required")
        )

        if not has_summary:
            logger.warning("Explanation missing SUMMARY section - prepending fallback")
            object_name = inspector_result.object_identified or "component"
            defect_count = len(consensus.get("combined_defects", []))
            verdict_str = verdict.get("verdict", "UNKNOWN")
            prefix = (
                f"EXECUTIVE SUMMARY\n\n"
                f"Inspection of {object_name} identified {defect_count} defect(s). "
                f"Final verdict: {verdict_str}. "
                "Both Inspector and Auditor models analyzed the image independently. "
            )
            critical_count = sum(
                1
                for d in consensus.get("combined_defects", [])
                if d.get("safety_impact") == "CRITICAL"
            )
            if defect_count > 0:
                prefix += (
                    f"{critical_count} critical defect(s) were detected. "
                    if critical_count
                    else "No critical defects detected. "
                )
            else:
                prefix += "No defects were detected. "
            explanation = prefix + "\n\n" + explanation

        if not has_recommendation:
            logger.warning("Explanation missing FINAL RECOMMENDATION - appending")
            verdict_str = verdict.get("verdict", "UNKNOWN")
            action = (
                "No action required"
                if verdict_str == "SAFE"
                else "Further inspection or remediation recommended"
            )
            explanation += (
                f"\n\nFINAL RECOMMENDATION\n\n"
                f"Verdict: {verdict_str}\n"
                f"Action Required: {action}\n"
                f"Safety Assessment: Based on the analysis, the component "
                f"{'appears safe' if verdict_str == 'SAFE' else 'requires attention'}."
            )

        # Counterfactual what-if analysis feeds the report's COUNTERFACTUAL
        # section (the reference defined but never wired this —
        # reference explainer.py:97; SURVEY §2 says make dormant parts
        # real).  The bundle generated it concurrently with the narration;
        # append it only when the narration lacks the section.
        if "counterfactual" not in explanation_lower and counterfactual:
            explanation += (
                "\n\nCOUNTERFACTUAL ANALYSIS\n\n" + counterfactual
            )

        state["explanation"] = explanation
        state["decision_support"] = decision_support
    except Exception as exc:
        logger.error(f"Explanation generation failed: {exc}", exc_info=True)
        inspector_result = state.get("inspector_result") or {}
        consensus = state.get("consensus") or {}
        verdict = state.get("safety_verdict") or {}
        object_name = inspector_result.get("object_identified", "component")
        defect_count = len(consensus.get("combined_defects", []))
        verdict_str = verdict.get("verdict", "UNKNOWN")
        state["explanation"] = (
            f"EXECUTIVE SUMMARY\n\n"
            f"Inspection of {object_name} identified {defect_count} defect(s). "
            f"Final verdict: {verdict_str}. "
            "Analysis was completed by both Inspector and Auditor models.\n\n"
            f"FINAL RECOMMENDATION\n\n"
            f"Verdict: {verdict_str}\n"
            f"Action Required: "
            f"{'No action required' if verdict_str == 'SAFE' else 'Further inspection recommended'}\n"
            f"Safety Assessment: "
            f"{'Component appears safe' if verdict_str == 'SAFE' else 'Component requires attention'}.\n\n"
            f"NOTE: Full explanation generation failed ({exc}). This summary was "
            "generated from structured findings."
        )
        state.setdefault("decision_support", {})
    return state


def save_to_database(state: InspectionState) -> InspectionState:
    state["current_step"] = "saving_to_database"
    try:
        repo = InspectionRepository()
        context = state["context"]
        verdict = state["safety_verdict"]
        consensus = state["consensus"]
        primary = _as_path_list(state["image_path"])[0]

        inspection_data = {
            "inspection_id": state["request_id"],
            "image_path": primary,
            "image_filename": Path(primary).name,
            "criticality": context.get("criticality"),
            "domain": context.get("domain"),
            "user_notes": context.get("user_notes"),
            "overall_verdict": verdict["verdict"],
            "defect_count": len(consensus["combined_defects"]),
            "critical_defect_count": sum(
                1
                for d in consensus["combined_defects"]
                if d["safety_impact"] == "CRITICAL"
            ),
            "inspector_confidence": state["inspector_result"]["overall_confidence"],
            "auditor_confidence": state["auditor_result"]["overall_confidence"],
            "models_agree": consensus["models_agree"],
            "agreement_score": consensus["agreement_score"],
            "triggered_gates": verdict["triggered_gates"],
            "requires_human": verdict["requires_human"],
            "processing_time_seconds": time.time() - state["start_time"],
            "report_path": state.get("report_path"),
        }

        # Provenance: merged defects keep their originating model's
        # defect_id, so auditor-only findings are attributable (analytics
        # on detection source would otherwise credit everything to the
        # inspector).
        inspector_ids = {
            d.get("defect_id")
            for d in state["inspector_result"].get("defects", [])
        }
        defects_data = []
        for defect in consensus["combined_defects"]:
            record = {
                "defect_id": defect["defect_id"],
                "defect_type": defect["type"],
                "location": defect["location"],
                "safety_impact": defect["safety_impact"],
                "reasoning": defect["reasoning"],
                "confidence": defect["confidence"],
                "recommended_action": defect["recommended_action"],
                "detected_by": (
                    "inspector" if defect["defect_id"] in inspector_ids
                    else "auditor"
                ),
            }
            if defect.get("bbox"):
                bbox = defect["bbox"]
                record.update(
                    bbox_x=bbox.get("x"),
                    bbox_y=bbox.get("y"),
                    bbox_width=bbox.get("width"),
                    bbox_height=bbox.get("height"),
                )
            defects_data.append(record)

        repo.create_inspection(inspection_data, defects_data)
    except Exception as exc:
        logger.error(f"Database save failed: {exc}", exc_info=True)
        state["error"] = f"Database save failed: {exc}"
    return state


def finalize_inspection(state: InspectionState) -> InspectionState:
    """Close out: PDF report, error consolidation, summary log
    (reference nodes.py:750-793)."""
    state["current_step"] = "completed"
    state["processing_time"] = time.time() - state["start_time"]

    if state.get("explanation") and not state.get("report_path"):
        try:
            from vis_tpu_torch.reporting import generate_report

            report_path = generate_report(state)
            state["report_path"] = str(report_path)
            logger.info(f"PDF report generated: {report_path}")
            # The database node persisted the row before the PDF existed;
            # backfill the path so /api/history rows can link the report.
            try:
                from vis_tpu_torch.database.repository import InspectionRepository

                InspectionRepository().set_report_path(
                    state["request_id"], str(report_path)
                )
            except Exception as exc:
                logger.warning(f"report_path backfill failed: {exc}")
        except Exception as exc:
            logger.error(f"PDF report generation failed: {exc}", exc_info=True)
            state["error"] = f"PDF generation failed: {exc}"

    errors = list(state.get("failure_history") or [])
    if state.get("error") and state["error"] not in errors:
        errors.append(state["error"])
    for err in (state.get("safety_verdict") or {}).get("errors", []):
        if err not in errors:
            errors.append(err)
    state["failure_history"] = errors

    logger.info(
        f"Inspection {state['request_id']} complete: "
        f"{(state.get('safety_verdict') or {}).get('verdict', 'UNKNOWN')} "
        f"in {state['processing_time']:.2f}s"
        + (f" ({len(errors)} error(s))" if errors else "")
    )
    return state


__all__ = [
    "initialize_inspection",
    "check_image_quality",
    "run_inspector",
    "run_auditor",
    "run_inspector_and_auditor",
    "analyze_consensus_node",
    "evaluate_safety_node",
    "human_review_node",
    "clean_verification_node",
    "generate_explanation",
    "save_to_database",
    "finalize_inspection",
]
