from vis_tpu_torch.orchestration.graph import (
    create_inspection_workflow,
    get_pending_reviews,
    resume_inspection,
    run_batch_inspection,
    run_inspection,
    run_inspection_streaming,
    run_multi_image_inspection,
)
from vis_tpu_torch.orchestration.session_aggregation import (
    aggregate_session_results,
    determine_aggregate_verdict,
)
from vis_tpu_torch.orchestration.state import InspectionState, validate_state

__all__ = [
    "InspectionState",
    "validate_state",
    "create_inspection_workflow",
    "run_inspection",
    "run_inspection_streaming",
    "run_multi_image_inspection",
    "run_batch_inspection",
    "resume_inspection",
    "get_pending_reviews",
    "aggregate_session_results",
    "determine_aggregate_verdict",
]
