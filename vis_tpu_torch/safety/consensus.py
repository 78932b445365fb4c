"""Deterministic agreement scoring between the inspector and auditor models.

Pure function of two VLMAnalysisResult values; must stay bit-identical to the
reference implementation (reference: src/safety/consensus.py:18-151).

The score is a weighted sum of four sub-signals:
  0.4 * condition match + 0.3 * defect-type Jaccard
  + 0.2 * count agreement (±1 tolerated) + 0.1 * confidence proximity
rounded to 4 decimals, snapped to 1.0 above 0.9999, with agreement declared
at >= 0.7.  A "both report zero defects" result only counts as agreement when
both models carry HIGH confidence; otherwise the type/condition terms are
zeroed (conservative stance, reference consensus.py:56-70).
"""

from __future__ import annotations

from typing import Optional

from vis_tpu_torch.schemas.models import ConsensusResult, VLMAnalysisResult
from vis_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__, level="INFO", component="CONSENSUS")

AGREEMENT_THRESHOLD = 0.7

_CONFIDENCE_RANK = {"high": 3, "medium": 2, "low": 1}


def analyze_consensus(
    inspector_result: VLMAnalysisResult,
    auditor_result: VLMAnalysisResult,
) -> ConsensusResult:
    """Score agreement between the two independent analyses."""
    conditions_agree = inspector_result.overall_condition == auditor_result.overall_condition

    n_inspector = len(inspector_result.defects)
    n_auditor = len(auditor_result.defects)

    inspector_types = set(inspector_result.defect_types)
    auditor_types = set(auditor_result.defect_types)
    shared_types = inspector_types & auditor_types
    union_types = inspector_types | auditor_types
    type_agreement = len(shared_types) / len(union_types) if union_types else 1.0

    # Clean-image special case: both say "no defects" but at least one lacks
    # HIGH confidence → force the agreement terms to zero so the gates treat
    # the result conservatively.
    if n_inspector == 0 and n_auditor == 0:
        both_high = (
            inspector_result.overall_confidence == "high"
            and auditor_result.overall_confidence == "high"
        )
        if not both_high:
            logger.warning(
                "Both models report zero defects without dual-HIGH confidence "
                f"(inspector={inspector_result.overall_confidence}, "
                f"auditor={auditor_result.overall_confidence}); forcing disagreement"
            )
            type_agreement = 0.0
            # Reference-parity (consensus.py:70): the forced override can
            # yield a "Inspector says 'good', Auditor says 'good'"
            # disagreement message when both conditions match — kept
            # bit-identical; Gate 3 embeds it verbatim.
            conditions_agree = False

    count_diff = abs(n_inspector - n_auditor)
    if count_diff <= 1:
        count_agreement = 1.0
    else:
        count_agreement = max(0, 1 - (count_diff / max(n_inspector, n_auditor, 1)))

    rank_i = _CONFIDENCE_RANK.get(inspector_result.overall_confidence, 2)
    rank_a = _CONFIDENCE_RANK.get(auditor_result.overall_confidence, 2)
    confidence_agreement = 1.0 - (abs(rank_i - rank_a) / 2)

    score = (
        0.4 * (1.0 if conditions_agree else 0.0)
        + 0.3 * type_agreement
        + 0.2 * count_agreement
        + 0.1 * confidence_agreement
    )
    score = round(score, 4)
    if score >= 0.9999:
        score = 1.0

    models_agree = score >= AGREEMENT_THRESHOLD

    disagreement_details: Optional[str] = None
    if not models_agree:
        parts = []
        if not conditions_agree:
            parts.append(
                f"Condition: Inspector says '{inspector_result.overall_condition}', "
                f"Auditor says '{auditor_result.overall_condition}'"
            )
        if n_inspector != n_auditor:
            parts.append(
                f"Count: Inspector found {n_inspector} defects, Auditor found {n_auditor}"
            )
        only_inspector = inspector_types - auditor_types
        only_auditor = auditor_types - inspector_types
        if only_inspector:
            parts.append(f"Inspector found: {', '.join(only_inspector)}")
        if only_auditor:
            parts.append(f"Auditor found: {', '.join(only_auditor)}")
        disagreement_details = "; ".join(parts)

    logger.info(
        f"Consensus: {'AGREE' if models_agree else 'DISAGREE'} (score: {score:.2f})"
    )
    if disagreement_details:
        logger.warning(f"Disagreement details: {disagreement_details}")

    return ConsensusResult(
        models_agree=models_agree,
        inspector_result=inspector_result,
        auditor_result=auditor_result,
        agreement_score=score,
        disagreement_details=disagreement_details,
    )


class ConsensusAnalyzer:
    """Class wrapper kept for API parity with the reference (consensus.py:12)."""

    def analyze(
        self,
        inspector_result: VLMAnalysisResult,
        auditor_result: VLMAnalysisResult,
    ) -> ConsensusResult:
        return analyze_consensus(inspector_result, auditor_result)


__all__ = ["analyze_consensus", "ConsensusAnalyzer", "AGREEMENT_THRESHOLD"]
