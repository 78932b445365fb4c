"""Typed-state pipeline runner with streaming events and checkpoint/resume.

Replaces the reference's LangGraph StateGraph (reference:
src/orchestration/graph.py:53-451) with a dependency-free runner: the
inspection workflow is a static, mostly linear DAG, so a list of named steps
with an optional conditional branch and interrupt points covers the whole
surface — and unlike the reference, the per-node event stream is actually
wired to consumers (the reference exported run_inspection_streaming but the
UI never used it; SURVEY.md §2 "dormant components").

Entry points (same public API as the reference):
  run_inspection, run_multi_image_inspection (+ run_batch_inspection alias,
  the README-documented name), run_inspection_streaming, resume_inspection,
  get_pending_reviews.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Callable, Dict, Iterator, List, Optional

from vis_tpu_torch.orchestration import nodes
from vis_tpu_torch.orchestration.session_aggregation import aggregate_session_results
from vis_tpu_torch.orchestration.state import InspectionState
from vis_tpu_torch.utils.config import config
from vis_tpu_torch.utils.logger import setup_logger
from vis_tpu_torch.utils.profiling import device_trace
from vis_tpu_torch.utils.validators import validate_inspection_context

logger = setup_logger(__name__, level="INFO", component="GRAPH")

NodeFn = Callable[[InspectionState], InspectionState]
EventCallback = Callable[[Dict[str, Any]], None]


class Step:
    """One pipeline node: a name, a function, and an optional guard."""

    def __init__(
        self,
        name: str,
        fn: NodeFn,
        condition: Optional[Callable[[InspectionState], bool]] = None,
        interrupt_before: Optional[Callable[[InspectionState], bool]] = None,
    ):
        self.name = name
        self.fn = fn
        self.condition = condition
        self.interrupt_before = interrupt_before


class Interrupted(Exception):
    """Raised internally when a step requests a human-in-the-loop pause."""

    def __init__(self, step_index: int):
        self.step_index = step_index


class Pipeline:
    """Sequential step executor with events, checkpoints, and interrupts."""

    def __init__(self, steps: List[Step]):
        self.steps = steps

    def run(
        self,
        state: InspectionState,
        on_event: Optional[EventCallback] = None,
        start_at: int = 0,
    ) -> InspectionState:
        def emit(event: Dict[str, Any]) -> None:
            if on_event is not None:
                try:
                    on_event(event)
                except Exception:  # consumers must not break the pipeline
                    logger.warning("Event callback raised; continuing", exc_info=True)

        for idx in range(start_at, len(self.steps)):
            step = self.steps[idx]
            if step.condition is not None and not step.condition(state):
                emit({"event": "node_skipped", "node": step.name, "index": idx})
                continue
            if step.interrupt_before is not None and step.interrupt_before(state):
                emit({"event": "interrupted", "node": step.name, "index": idx})
                raise Interrupted(idx)
            emit({"event": "node_start", "node": step.name, "index": idx,
                  "total": len(self.steps)})
            t0 = time.perf_counter()
            # PROFILE_DIR set -> per-node xplane trace (SURVEY §5.1);
            # device_trace is a pure pass-through when profiling is off.
            with device_trace(step.name):
                state = step.fn(state)
            emit({
                "event": "node_end",
                "node": step.name,
                "index": idx,
                "total": len(self.steps),
                "elapsed_s": round(time.perf_counter() - t0, 4),
                "current_step": state.get("current_step"),
            })
        emit({"event": "complete", "state": state})
        return state


# ---------------------------------------------------------------------------
# Workflow definition
# ---------------------------------------------------------------------------

def _needs_blocking_review(state: InspectionState) -> bool:
    """Interrupt guard for human review.  Disabled by default for parity with
    the reference, whose conditional edge always bypassed review
    (reference graph.py:39-50); enable with interactive_review=True."""
    return bool(state.get("_interactive_review")) and bool(
        state.get("requires_human_review")
    )


def create_inspection_workflow() -> Pipeline:
    """Build the inspection DAG (reference graph.py:53-107)."""
    return Pipeline(
        [
            Step("initialize", nodes.initialize_inspection),
            Step("quality_check", nodes.check_image_quality),
            Step("dual_vlm", nodes.run_inspector_and_auditor),
            Step("consensus", nodes.analyze_consensus_node),
            Step("safety_gates", nodes.evaluate_safety_node),
            Step("clean_verification", nodes.clean_verification_node),
            Step(
                "human_review",
                nodes.human_review_node,
                condition=lambda s: bool(s.get("requires_human_review")),
                interrupt_before=_needs_blocking_review,
            ),
            Step("explanation", nodes.generate_explanation),
            Step("database", nodes.save_to_database),
            Step("finalize", nodes.finalize_inspection),
        ]
    )


def _initial_state(
    image_path: str,
    criticality: str,
    domain: Optional[str],
    user_notes: Optional[str],
    request_id: Optional[str],
    interactive_review: bool = False,
) -> InspectionState:
    request_id = request_id or str(uuid.uuid4())[:8]
    # Validate + normalize user-supplied context fields at the entry point
    # (reference utils/validators.py contract): a malformed criticality from
    # an HTTP form must fail fast with an actionable message, not explode
    # inside a pipeline node as a pydantic ValidationError.  Image-path
    # problems intentionally stay on the degradation path (quality check ->
    # Gate 0) rather than raising here.
    ok, errors, normalized = validate_inspection_context(
        image_path if isinstance(image_path, str) else "",
        criticality,
        domain,
        user_notes,
    )
    context_errors = [e for e in errors if not e.startswith("Image:")]
    if context_errors:
        raise ValueError("Invalid inspection request: " + "; ".join(context_errors))
    state: InspectionState = {
        "image_path": image_path,
        "context": {
            "image_id": request_id,
            "criticality": normalized.get("criticality", criticality),
            "domain": normalized.get("domain", domain),
            "user_notes": normalized.get("user_notes", user_notes),
        },
        "request_id": request_id,
        "start_time": time.time(),
        "inspector_result": None,
        "auditor_result": None,
        "consensus": None,
        "safety_verdict": None,
        "clean_verification": None,
        "requires_human_review": False,
        "human_decision": None,
        "human_notes": None,
        "explanation": None,
        "report_path": None,
        "processing_time": None,
        "error": None,
        "failure_history": [],
        "has_critical_failure": False,
        "inspector_retry_count": 0,
        "auditor_retry_count": 0,
        "image_quality": None,
        "current_step": "pending",
    }
    if interactive_review:
        state["_interactive_review"] = True  # type: ignore[typeddict-unknown-key]
    return state


# Parked interrupted runs: thread_id -> (pipeline, state, resume_index).
_active_workflows: Dict[str, Dict[str, Any]] = {}
_workflows_lock = threading.Lock()


def run_inspection(
    image_path: str,
    criticality: str = "medium",
    domain: Optional[str] = None,
    user_notes: Optional[str] = None,
    request_id: Optional[str] = None,
    on_event: Optional[EventCallback] = None,
    interactive_review: bool = False,
) -> InspectionState:
    """Run one complete inspection (reference graph.py:133-226)."""
    pipeline = create_inspection_workflow()
    state = _initial_state(
        image_path, criticality, domain, user_notes, request_id, interactive_review
    )
    thread_id = state["request_id"]
    try:
        return pipeline.run(state, on_event=on_event)
    except Interrupted as stop:
        with _workflows_lock:
            _active_workflows[thread_id] = {
                "pipeline": pipeline,
                "state": state,
                "resume_index": stop.step_index,
                "parked_at": time.time(),
            }
        logger.info(f"Inspection {thread_id} parked for human review")
        state["current_step"] = "awaiting_human_review"
        return state


def resume_inspection(
    thread_id: str,
    decision: str,
    notes: Optional[str] = None,
    on_event: Optional[EventCallback] = None,
) -> InspectionState:
    """Resume a parked run with a human decision
    (reference graph.py:229-266)."""
    with _workflows_lock:
        parked = _active_workflows.pop(thread_id, None)
    if parked is None:
        raise KeyError(f"No pending workflow for thread {thread_id}")
    state: InspectionState = parked["state"]
    state["human_decision"] = decision
    state["human_notes"] = notes
    state["_interactive_review"] = False  # type: ignore[typeddict-unknown-key]
    if decision == "reject":
        verdict = state.get("safety_verdict") or {}
        verdict["verdict"] = "UNSAFE"
        verdict["reason"] = (
            f"Human reviewer rejected the component. Notes: {notes or 'none'}"
        )
        state["safety_verdict"] = verdict
    elif decision == "approve":
        verdict = state.get("safety_verdict") or {}
        verdict["requires_human"] = False
        if verdict.get("verdict") == "REQUIRES_HUMAN_REVIEW":
            # The reviewer's sign-off RESOLVES the review: leaving the
            # verdict at REQUIRES_HUMAN_REVIEW would persist an approved
            # component as still pending in the DB, PDF stamp, and review
            # API.  An UNSAFE parked for confirmation stays UNSAFE —
            # approval acknowledges it, it does not clear the hazard.
            verdict["verdict"] = "SAFE"
            verdict["reason"] = (
                "Human reviewer approved the component. "
                f"Notes: {notes or 'none'}"
            )
        state["safety_verdict"] = verdict
    pipeline: Pipeline = parked["pipeline"]
    return pipeline.run(state, on_event=on_event, start_at=parked["resume_index"])


def get_pending_reviews() -> List[Dict[str, Any]]:
    """List parked runs awaiting review (reference graph.py:390-403)."""
    with _workflows_lock:
        return [
            {
                "thread_id": tid,
                "parked_at": info["parked_at"],
                "verdict": (info["state"].get("safety_verdict") or {}).get("verdict"),
                "reason": (info["state"].get("safety_verdict") or {}).get("reason"),
            }
            for tid, info in _active_workflows.items()
        ]


def run_inspection_streaming(
    image_path: str,
    criticality: str = "medium",
    domain: Optional[str] = None,
    user_notes: Optional[str] = None,
    request_id: Optional[str] = None,
) -> Iterator[Dict[str, Any]]:
    """Generator of progress events ending with the final state
    (makes the reference's dormant streaming API real;
    reference graph.py:406-451)."""
    import queue

    q: "queue.Queue[Optional[Dict[str, Any]]]" = queue.Queue()

    def worker() -> None:
        try:
            run_inspection(
                image_path, criticality, domain, user_notes, request_id,
                on_event=q.put,
            )
        except Exception as exc:  # surface as an event, never swallow
            q.put({"event": "error", "error": str(exc)})
        finally:
            q.put(None)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    while True:
        event = q.get()
        if event is None:
            break
        yield event
    thread.join()


def run_multi_image_inspection(
    image_paths: List[str],
    criticality: str = "medium",
    domain: Optional[str] = None,
    user_notes: Optional[str] = None,
    session_id: Optional[str] = None,
    on_event: Optional[EventCallback] = None,
) -> Dict[str, Any]:
    """Inspect a batch of images and aggregate to a session verdict
    (reference graph.py:269-387).

    Images run through the pipeline with bounded concurrency
    (config.max_concurrent_calls); the reference processed them strictly
    sequentially.
    """
    from concurrent.futures import ThreadPoolExecutor

    session_id = session_id or str(uuid.uuid4())[:8]
    session_start = time.time()
    image_results: Dict[str, Dict[str, Any]] = {}

    def inspect_one(idx_path):
        idx, path = idx_path
        image_id = f"{session_id}-img{idx:03d}"
        # Tag events so session consumers can track per-image progress.
        tagged = (
            None if on_event is None
            else (lambda ev, _iid=image_id: on_event({**ev, "image_id": _iid}))
        )
        try:
            final = run_inspection(
                path, criticality, domain, user_notes,
                request_id=image_id, on_event=tagged,
            )
            return image_id, {
                "completed": final.get("safety_verdict") is not None,
                "image_path": path,
                "safety_verdict": final.get("safety_verdict") or {},
                "consensus": final.get("consensus") or {},
                "explanation": final.get("explanation"),
                "report_path": final.get("report_path"),
                "processing_time": final.get("processing_time"),
                "failure_history": final.get("failure_history") or [],
            }
        except Exception as exc:
            logger.error(f"Inspection of {path} failed: {exc}", exc_info=True)
            return image_id, {"completed": False, "image_path": path, "error": str(exc)}

    workers = max(1, config.max_concurrent_calls)
    if workers == 1 or len(image_paths) == 1:
        results = [inspect_one(ip) for ip in enumerate(image_paths)]
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            results = list(pool.map(inspect_one, enumerate(image_paths)))
    image_results = dict(results)

    summary = aggregate_session_results(image_results)
    return {
        "session_id": session_id,
        "duration_seconds": round(time.time() - session_start, 3),
        "image_results": image_results,
        "per_image_verdicts": {
            iid: r.get("safety_verdict", {}).get("verdict", "UNKNOWN")
            for iid, r in image_results.items()
        },
        **summary,
    }


# The README of the reference documents `run_batch_inspection` even though the
# implementation only shipped `run_multi_image_inspection`
# (reference README.md:154 vs graph.py:269); expose both.
run_batch_inspection = run_multi_image_inspection


__all__ = [
    "Pipeline",
    "Step",
    "create_inspection_workflow",
    "run_inspection",
    "run_inspection_streaming",
    "run_multi_image_inspection",
    "run_batch_inspection",
    "resume_inspection",
    "get_pending_reviews",
]
