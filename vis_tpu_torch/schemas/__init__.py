from vis_tpu_torch.schemas.models import (
    BoundingBox,
    ConsensusResult,
    DefectInfo,
    InspectionContext,
    SafetyVerdict,
    VLMAnalysisResult,
)

__all__ = [
    "BoundingBox",
    "DefectInfo",
    "VLMAnalysisResult",
    "ConsensusResult",
    "SafetyVerdict",
    "InspectionContext",
]
