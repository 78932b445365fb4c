"""Core data contract for the inspection pipeline.

These pydantic models define the bit-exact verdict surface shared with the
reference system (reference: src/schemas/models.py:11-280): percentage-space
bounding boxes, normalized defect records, per-model analysis results, the
consensus result with its defect-merge validator (semantic type groups plus
IoU >= 0.5 de-duplication), the safety verdict, and the inspection context.
Downstream consensus scoring and gate evaluation are pure functions of these
models, so their semantics must not drift.
"""

from __future__ import annotations

import itertools
import time
from datetime import datetime, timezone
from typing import Any, Dict, List, Literal, Optional

from pydantic import BaseModel, Field, field_validator, model_validator

Severity = Literal["CRITICAL", "MODERATE", "COSMETIC"]
ConfidenceLevel = Literal["high", "medium", "low"]
Condition = Literal["damaged", "good", "uncertain"]
Verdict = Literal["SAFE", "UNSAFE", "REQUIRES_HUMAN_REVIEW"]
Criticality = Literal["low", "medium", "high"]

# Defect types treated as synonymous when merging findings across the two
# models (reference src/schemas/models.py:158-164).
SEMANTIC_TYPE_GROUPS: List[frozenset] = [
    frozenset({"crack", "hairline_crack", "fracture", "fissure"}),
    frozenset({"rust", "corrosion", "oxidation"}),
    frozenset({"scratch", "scrape", "abrasion"}),
    frozenset({"dent", "deformation"}),
    frozenset({"discoloration", "stain"}),
]

IOU_MERGE_THRESHOLD = 0.5


def _utcnow() -> datetime:
    return datetime.now(timezone.utc)


_DEFECT_ID_COUNTER = itertools.count()


class BoundingBox(BaseModel):
    """Axis-aligned box in percentage space: all fields are 0-100 relative to
    image dimensions (reference src/schemas/models.py:11-54)."""

    x: float = Field(..., description="Left edge, % of image width (0-100)")
    y: float = Field(..., description="Top edge, % of image height (0-100)")
    width: float = Field(..., description="Box width, % of image width (0-100]")
    height: float = Field(..., description="Box height, % of image height (0-100]")

    @field_validator("x", "y", "width", "height")
    @classmethod
    def _non_negative(cls, v: float) -> float:
        if v < 0:
            raise ValueError("coordinates must be non-negative")
        return v

    @model_validator(mode="after")
    def _within_bounds(self) -> "BoundingBox":
        if not 0 <= self.x <= 100:
            raise ValueError(f"x out of range [0, 100]: {self.x}")
        if not 0 <= self.y <= 100:
            raise ValueError(f"y out of range [0, 100]: {self.y}")
        if not 0 < self.width <= 100:
            raise ValueError(f"width out of range (0, 100]: {self.width}")
        if not 0 < self.height <= 100:
            raise ValueError(f"height out of range (0, 100]: {self.height}")
        if self.x + self.width > 100:
            raise ValueError(f"box exceeds right edge: x+width={self.x + self.width} > 100")
        if self.y + self.height > 100:
            raise ValueError(f"box exceeds bottom edge: y+height={self.y + self.height} > 100")
        return self

    @property
    def area_percent(self) -> float:
        """Box area as a percentage of total image area."""
        return (self.width * self.height) / 100.0

    def is_reasonable(self, min_area_percent: float = 0.1, max_area_percent: float = 50.0) -> bool:
        """True when the box covers a plausible fraction of the image."""
        return min_area_percent <= self.area_percent <= max_area_percent

    def iou(self, other: "BoundingBox") -> float:
        """Intersection-over-union with another percentage-space box."""
        ix0 = max(self.x, other.x)
        iy0 = max(self.y, other.y)
        ix1 = min(self.x + self.width, other.x + other.width)
        iy1 = min(self.y + self.height, other.y + other.height)
        if ix1 <= ix0 or iy1 <= iy0:
            return 0.0
        inter = (ix1 - ix0) * (iy1 - iy0)
        union = self.width * self.height + other.width * other.height - inter
        if union == 0:
            return 0.0
        return inter / union


class DefectInfo(BaseModel):
    """A single detected defect (reference src/schemas/models.py:57-82)."""

    # Millisecond prefix keeps IDs time-sortable (reference format,
    # src/schemas/models.py:59-61); the process-wide counter suffix makes
    # them unique — same-millisecond parses are routine when inspector and
    # auditor results arrive concurrently, and save_to_database attributes
    # detected_by via ID-set membership.
    defect_id: str = Field(
        default_factory=lambda: (
            f"defect_{int(time.time() * 1000)}_{next(_DEFECT_ID_COUNTER)}"
        )
    )
    type: str = Field(..., description="Defect type, e.g. crack, rust")
    location: str = Field(..., description="Human-readable location")
    bbox: Optional[BoundingBox] = Field(None, description="Box when localizable")
    safety_impact: Severity = Field(..., description="CRITICAL / MODERATE / COSMETIC")
    reasoning: str = Field(..., description="Why this matters")
    confidence: ConfidenceLevel = Field(..., description="Detection confidence")
    recommended_action: str = Field(..., description="Suggested remediation")

    @field_validator("type")
    @classmethod
    def _normalize_type(cls, v: str) -> str:
        return v.lower().strip()

    def is_critical(self) -> bool:
        return self.safety_impact == "CRITICAL"


def defect_types_similar(type_a: str, type_b: str) -> bool:
    """Whether two defect types refer to the same physical phenomenon."""
    a = type_a.lower().strip()
    b = type_b.lower().strip()
    if a == b:
        return True
    return any(a in group and b in group for group in SEMANTIC_TYPE_GROUPS)


class VLMAnalysisResult(BaseModel):
    """Output of one model's image analysis (reference src/schemas/models.py:85-131)."""

    object_identified: str = Field(..., description="Object/component in the image")
    overall_condition: Condition = Field(..., description="Overall assessment")
    defects: List[DefectInfo] = Field(default_factory=list)
    overall_confidence: ConfidenceLevel = Field(..., description="Analysis confidence")
    analysis_reasoning: Optional[str] = Field(None, description="Free-form reasoning")
    inferred_criticality: Optional[Criticality] = Field(
        None, description="Model-inferred criticality of the component"
    )
    inferred_criticality_reasoning: Optional[str] = None
    analysis_failed: bool = Field(default=False)
    failure_reason: Optional[str] = None
    timestamp: datetime = Field(default_factory=_utcnow)

    @property
    def has_defects(self) -> bool:
        return bool(self.defects)

    @property
    def critical_defect_count(self) -> int:
        return sum(1 for d in self.defects if d.is_critical())

    @property
    def defect_types(self) -> List[str]:
        return list({d.type for d in self.defects})


class ConsensusResult(BaseModel):
    """Agreement analysis across inspector and auditor, with merged defects
    (reference src/schemas/models.py:134-241)."""

    models_agree: bool
    inspector_result: VLMAnalysisResult
    auditor_result: VLMAnalysisResult
    agreement_score: float = Field(..., ge=0, le=1)
    disagreement_details: Optional[str] = None
    combined_defects: List[DefectInfo] = Field(default_factory=list)

    @model_validator(mode="after")
    def _merge_defects(self) -> "ConsensusResult":
        """Merge the two defect lists.

        An inspector defect absorbs the first unmatched auditor defect that is
        semantically the same type AND whose bbox overlaps with IoU >= 0.5
        (inspector's record wins).  Same-type defects at different locations
        are kept as distinct findings; every unmatched auditor defect is
        appended afterwards.  Mirrors reference src/schemas/models.py:145-241.
        """
        merged: List[DefectInfo] = []
        auditor_defects = list(self.auditor_result.defects)
        consumed = [False] * len(auditor_defects)

        for ins_defect in self.inspector_result.defects:
            absorbed = False
            for idx, aud_defect in enumerate(auditor_defects):
                if consumed[idx]:
                    continue
                if not defect_types_similar(ins_defect.type, aud_defect.type):
                    continue
                if (
                    ins_defect.bbox is not None
                    and aud_defect.bbox is not None
                    and ins_defect.bbox.iou(aud_defect.bbox) >= IOU_MERGE_THRESHOLD
                ):
                    merged.append(ins_defect)
                    consumed[idx] = True
                    absorbed = True
                    break
            if not absorbed:
                merged.append(ins_defect)

        for idx, aud_defect in enumerate(auditor_defects):
            if not consumed[idx]:
                merged.append(aud_defect)

        self.combined_defects = merged
        return self


class SafetyVerdict(BaseModel):
    """Final decision from the deterministic gate engine
    (reference src/schemas/models.py:244-261)."""

    verdict: Verdict
    reason: str
    requires_human: bool
    confidence_level: ConfidenceLevel
    triggered_gates: List[str] = Field(default_factory=list)
    defect_summary: Dict[str, Any] = Field(default_factory=dict)
    errors: List[str] = Field(default_factory=list)
    timestamp: datetime = Field(default_factory=_utcnow)


class InspectionContext(BaseModel):
    """User-provided context for a single inspection
    (reference src/schemas/models.py:264-270)."""

    image_id: str
    criticality: Criticality = "medium"
    domain: Optional[str] = None
    reference_standards: Optional[List[str]] = None
    user_notes: Optional[str] = None


__all__ = [
    "BoundingBox",
    "DefectInfo",
    "VLMAnalysisResult",
    "ConsensusResult",
    "SafetyVerdict",
    "InspectionContext",
    "defect_types_similar",
    "SEMANTIC_TYPE_GROUPS",
    "IOU_MERGE_THRESHOLD",
    "Severity",
    "ConfidenceLevel",
    "Condition",
    "Verdict",
    "Criticality",
]
