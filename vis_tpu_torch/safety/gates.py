"""Deterministic safety-gate engine.

Evaluates nine named gates plus a conservative fallback over a ConsensusResult
and InspectionContext.  Every gate's pass/fail is recorded for the audit trail;
the FIRST failing gate that produces a decision wins ("blocking result"), and
the engine auto-decides rather than deferring to humans except for analysis
errors (Gate 0).  Decision semantics are kept bit-identical to the reference
engine (reference: src/safety/gates.py:94-784); see the gate table in
SURVEY.md §2 for the contract.

Gate order and outcomes:
  0 error state          -> UNSAFE (low, human review)
  pre-filter             -> drops invalid-bbox / low-confidence / likely-false-positive defects
  1 critical defect      -> UNSAFE (high if agree, medium otherwise)
  2 domain zero-tolerance-> UNSAFE (high)
  3 model disagreement   -> UNSAFE (medium) if defects else SAFE (medium)
  4 low confidence       -> UNSAFE (low) if defects else SAFE (low)
  5 defect count         -> UNSAFE (medium) above config.max_defects_auto
  6 high criticality     -> UNSAFE (high) with defects; SAFE (medium) clean w/o dual-HIGH conf
  7 verified clean       -> SAFE (high) when nothing blocked and all clean criteria hold
  8 auditor uncertain    -> UNSAFE (low) if defects else SAFE (low)
  default conservative   -> cosmetic-only SAFE; any MODERATE -> UNSAFE
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import yaml

from vis_tpu_torch.schemas.models import (
    ConsensusResult,
    DefectInfo,
    InspectionContext,
    SafetyVerdict,
)
from vis_tpu_torch.utils.config import config
from vis_tpu_torch.utils.logger import setup_logger

logger = setup_logger(__name__, level="INFO", component="SAFETY")

SAFETY_RULES_PATH = Path(__file__).resolve().parent.parent.parent / "configs" / "safety_rules.yaml"

# Gate identifiers (stable public names; reference gates.py:28-37)
GATE_ERROR_STATE = "GATE_0_ERROR_STATE"
GATE_CRITICAL_DEFECT = "GATE_1_CRITICAL_DEFECT"
GATE_DOMAIN_ZERO_TOLERANCE = "GATE_2_DOMAIN_ZERO_TOLERANCE"
GATE_MODEL_DISAGREEMENT = "GATE_3_MODEL_DISAGREEMENT"
GATE_LOW_CONFIDENCE = "GATE_4_LOW_CONFIDENCE"
GATE_DEFECT_COUNT = "GATE_5_DEFECT_COUNT"
GATE_HIGH_CRITICALITY = "GATE_6_HIGH_CRITICALITY"
GATE_NO_DEFECTS = "GATE_7_NO_DEFECTS"
GATE_AUDITOR_UNCERTAIN = "GATE_8_AUDITOR_UNCERTAIN"
GATE_DEFAULT_CONSERVATIVE = "GATE_DEFAULT_CONSERVATIVE"

GATE_DISPLAY_NAMES = {
    GATE_ERROR_STATE: "Error State Check",
    GATE_CRITICAL_DEFECT: "Critical Defect Check",
    GATE_DOMAIN_ZERO_TOLERANCE: "Domain Zero Tolerance",
    GATE_MODEL_DISAGREEMENT: "Model Agreement Check",
    GATE_LOW_CONFIDENCE: "Confidence Threshold",
    GATE_DEFECT_COUNT: "Defect Count Limit",
    GATE_HIGH_CRITICALITY: "High Criticality Check",
    GATE_NO_DEFECTS: "No Defects Verification",
    GATE_AUDITOR_UNCERTAIN: "Auditor Certainty Check",
    GATE_DEFAULT_CONSERVATIVE: "Conservative Fallback",
}

# Defect bbox plausibility window, % of image area (reference gates.py:210-214).
MIN_BBOX_AREA_PCT = 0.05
MAX_BBOX_AREA_PCT = 50.0
VERY_LOW_AGREEMENT = 0.4
CRITICAL_LOW_AGREEMENT = 0.5
CLEAN_AGREEMENT_FLOOR = 0.8


_rules_cache: Dict[Any, Tuple[float, Dict[str, Any]]] = {}
_rules_lock = threading.Lock()


def load_safety_rules(path: Optional[Path] = None) -> Dict[str, Any]:
    """Load domain rules / agent-trust settings from YAML; {} when absent.

    Cached per (path, mtime): evaluate_safety runs on every inspection and
    must not pay a YAML parse per verdict; editing the rules file still
    takes effect on the next inspection via the mtime check.
    """
    rules_path = path or SAFETY_RULES_PATH
    try:
        if rules_path.exists():
            mtime = rules_path.stat().st_mtime_ns
            key = str(rules_path)
            with _rules_lock:
                cached = _rules_cache.get(key)
                if cached is not None and cached[0] == mtime:
                    return cached[1]
            with open(rules_path) as fh:
                rules = yaml.safe_load(fh) or {}
            with _rules_lock:
                _rules_cache[key] = (mtime, rules)
            return rules
    except Exception as exc:  # malformed rules never crash the gate engine
        logger.warning(f"Could not load safety rules from {rules_path}: {exc}")
    return {}


class GateResult:
    """Outcome of a single gate evaluation (reference gates.py:65-91)."""

    def __init__(
        self,
        gate_id: str,
        passed: bool,
        message: str = "",
        details: Optional[Dict[str, Any]] = None,
    ):
        self.gate_id = gate_id
        self.passed = passed
        self.message = message
        self.details = details or {}

    @property
    def display_name(self) -> str:
        return GATE_DISPLAY_NAMES.get(self.gate_id, self.gate_id)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "gate_id": self.gate_id,
            "display_name": self.display_name,
            "passed": self.passed,
            "message": self.message,
            "details": self.details,
        }


def _bbox_out_of_range(defect: DefectInfo) -> bool:
    """True when a defect carries a bbox with impossible coordinates.

    Defense-in-depth mirroring the reference gate engine (reference
    src/safety/gates.py:186-215).  A validated BoundingBox can never be
    out-of-range (schemas/models.py enforces the same bounds at
    construction), so on the normal parse path this never fires; it guards
    against validation-skipping construction (model_construct, deserialized
    state) and future schema relaxation — the gate engine must not trust
    its input layer.
    """
    b = defect.bbox
    if b is None:
        return False
    return (
        b.x < 0 or b.x > 100
        or b.y < 0 or b.y > 100
        or b.width <= 0 or b.width > 100
        or b.height <= 0 or b.height > 100
        or b.x + b.width > 100
        or b.y + b.height > 100
    )


class SafetyGateEngine:
    """Stateless gate evaluator; construct once per process or per call."""

    def __init__(self, rules: Optional[Dict[str, Any]] = None):
        self.rules = rules if rules is not None else load_safety_rules()
        self.domains: Dict[str, Any] = self.rules.get("domains", {})
        self.agent_trust: Dict[str, Any] = self.rules.get(
            "agent_trust", {"trust_agent_severity": True}
        )

    # -- domain helpers ------------------------------------------------
    def _domain_rules(self, domain: Optional[str]) -> Dict[str, Any]:
        if domain and domain.lower() in self.domains:
            return self.domains[domain.lower()]
        return self.domains.get("general", {})

    def _flagged_for_domain(self, defect_type: str, domain: Optional[str]) -> bool:
        zero_tolerance = self._domain_rules(domain).get("zero_tolerance_types", [])
        needle = defect_type.lower()
        return any(
            zt.lower() in needle or needle in zt.lower() for zt in zero_tolerance
        )

    @staticmethod
    def _confidence_numeric(conf: Optional[str]) -> float:
        return {"high": 0.9, "medium": 0.6, "low": 0.3}.get(
            conf.lower() if conf else "low", 0.5
        )

    # -- defect pre-filter ---------------------------------------------
    def _filter_defects(
        self, consensus: ConsensusResult, context: InspectionContext
    ) -> List[DefectInfo]:
        """Drop implausible or likely-false-positive defects before gating
        (reference gates.py:186-287)."""
        n_inspector = len(consensus.inspector_result.defects)
        n_auditor = len(consensus.auditor_result.defects)
        very_low_agreement = consensus.agreement_score < VERY_LOW_AGREEMENT
        one_sided = (n_inspector == 0) != (n_auditor == 0)

        ins = consensus.inspector_result
        aud = consensus.auditor_result
        inspector_clean_high = (
            n_inspector == 0
            and ins.overall_confidence == "high"
            and ins.overall_condition == "good"
        )
        auditor_clean_high = (
            n_auditor == 0
            and aud.overall_confidence == "high"
            and aud.overall_condition == "good"
        )
        both_say_good = ins.overall_condition == "good" and aud.overall_condition == "good"
        confident_both_good = (
            both_say_good
            and ins.overall_confidence in ("high", "medium")
            and aud.overall_confidence in ("high", "medium")
            and (n_inspector > 0 or n_auditor > 0)
        )

        kept: List[DefectInfo] = []
        for defect in consensus.combined_defects:
            if defect.bbox is not None:
                if _bbox_out_of_range(defect):
                    logger.warning(f"Dropping defect '{defect.type}': invalid bbox")
                    continue
                area = defect.bbox.area_percent
                if area < MIN_BBOX_AREA_PCT or area > MAX_BBOX_AREA_PCT:
                    logger.warning(
                        f"Dropping defect '{defect.type}': implausible bbox area {area:.2f}%"
                    )
                    continue

            # Reference-parity (gates.py:218): low-confidence defects drop
            # REGARDLESS of severity on non-high criticality — deliberately
            # kept bit-identical even though it can drop a low-confidence
            # CRITICAL finding; the verdict contract owns this tradeoff.
            if defect.confidence == "low" and context.criticality != "high":
                logger.debug(
                    f"Dropping low-confidence defect '{defect.type}' "
                    f"(criticality={context.criticality})"
                )
                continue

            non_critical = defect.safety_impact in ("MODERATE", "COSMETIC")
            if non_critical:
                # FP strategy 1: a model confidently declared the image clean.
                if inspector_clean_high or auditor_clean_high:
                    logger.warning(
                        f"Dropping likely false positive '{defect.type}': one model "
                        "confidently reported a clean image"
                    )
                    continue
                # FP strategies 2+3: both say "good" with decent confidence,
                # yet a defect was reported without high confidence.
                if confident_both_good and defect.confidence != "high":
                    logger.warning(
                        f"Dropping likely false positive '{defect.type}': both models "
                        f"report 'good' but a {defect.confidence}-confidence defect appeared"
                    )
                    continue
                # FP strategy 4: strong one-sided disagreement.
                if very_low_agreement and one_sided:
                    if inspector_clean_high or auditor_clean_high or (
                        both_say_good and defect.confidence in ("low", "medium")
                    ):
                        logger.warning(
                            f"Dropping likely false positive '{defect.type}': "
                            f"agreement {consensus.agreement_score:.0%} and only one "
                            "model reported defects"
                        )
                        continue

            kept.append(defect)
        return kept

    # -- main evaluation ------------------------------------------------
    def evaluate(
        self, consensus: ConsensusResult, context: InspectionContext
    ) -> SafetyVerdict:
        logger.info("Evaluating all safety gates")

        all_gates: List[GateResult] = []
        triggered: List[str] = []
        # (verdict, reason, confidence, requires_human) of the first failure
        blocking: Optional[Tuple[str, str, str, bool]] = None

        errors: List[str] = []
        if consensus.inspector_result.analysis_failed:
            errors.append(
                f"Inspector: {consensus.inspector_result.failure_reason or 'Analysis failed'}"
            )
        if consensus.auditor_result.analysis_failed:
            errors.append(
                f"Auditor: {consensus.auditor_result.failure_reason or 'Analysis failed'}"
            )

        # Gate 0 — error state ------------------------------------------
        gate0 = GateResult(
            GATE_ERROR_STATE,
            passed=not errors,
            message="No analysis errors" if not errors else f"{len(errors)} analysis error(s)",
            details={"errors": errors} if errors else {},
        )
        all_gates.append(gate0)
        if not gate0.passed:
            triggered.append(GATE_ERROR_STATE)
            summary = "; ".join(errors)
            blocking = ("UNSAFE", f"Analysis failed: {summary}", "low", True)
            logger.error(f"Gate 0 FAILED: {summary}")

        # Pre-filter ----------------------------------------------------
        defects = self._filter_defects(consensus, context)
        defect_count = len(defects)
        critical = [d for d in defects if d.safety_impact == "CRITICAL"]
        moderate = [d for d in defects if d.safety_impact == "MODERATE"]
        cosmetic = [d for d in defects if d.safety_impact == "COSMETIC"]

        ins_conf = consensus.inspector_result.overall_confidence
        aud_conf = consensus.auditor_result.overall_confidence
        aud_condition = consensus.auditor_result.overall_condition
        domain_rules = self._domain_rules(context.domain)

        # Gate 1 — critical defects -------------------------------------
        shaky_critical = (
            bool(critical)
            and consensus.agreement_score < CRITICAL_LOW_AGREEMENT
            and not consensus.models_agree
        )
        gate1 = GateResult(
            GATE_CRITICAL_DEFECT,
            passed=not critical,
            message=f"{'No' if not critical else len(critical)} critical defects",
            details={
                "critical_count": len(critical),
                "types": [d.type for d in critical],
                "low_agreement_warning": shaky_critical,
            },
        )
        all_gates.append(gate1)
        if not gate1.passed and blocking is None:
            triggered.append(GATE_CRITICAL_DEFECT)
            names = ", ".join(d.type for d in critical)
            if shaky_critical:
                blocking = (
                    "UNSAFE",
                    f"Critical defect(s) detected but models strongly disagree "
                    f"(agreement: {consensus.agreement_score:.0%}). Found: {names}. "
                    "Conservative verdict: UNSAFE (automated decision).",
                    "medium",
                    False,
                )
            else:
                blocking = (
                    "UNSAFE",
                    f"Agent detected {len(critical)} critical safety defect(s): {names}",
                    "high" if consensus.models_agree else "medium",
                    False,
                )
            logger.warning(f"Gate 1 FAILED: {len(critical)} critical defects")

        # Gate 2 — domain zero tolerance --------------------------------
        # Reference-parity (gates.py:366): zero-tolerance types only block
        # when the domain ALSO sets require_human_review_always — domains
        # with the flag false keep their list advisory, bit-identically.
        flagged = [d for d in defects if self._flagged_for_domain(d.type, context.domain)]
        gate2_passed = not (flagged and domain_rules.get("require_human_review_always", False))
        gate2 = GateResult(
            GATE_DOMAIN_ZERO_TOLERANCE,
            passed=gate2_passed,
            message="Passed" if gate2_passed else f"{len(flagged)} domain violations",
            details={"domain": context.domain, "flagged": [d.type for d in flagged]},
        )
        all_gates.append(gate2)
        if not gate2_passed and blocking is None:
            triggered.append(GATE_DOMAIN_ZERO_TOLERANCE)
            blocking = (
                "UNSAFE",
                f"Domain '{context.domain}' violation detected: "
                f"{', '.join(d.type for d in flagged)} - automatically marked UNSAFE",
                "high",
                False,
            )
            logger.warning("Gate 2 FAILED: domain zero-tolerance violation")

        # Gate 3 — model agreement --------------------------------------
        gate3 = GateResult(
            GATE_MODEL_DISAGREEMENT,
            passed=consensus.models_agree,
            message=f"Agreement: {consensus.agreement_score:.0%}",
            details={
                "agreement_score": consensus.agreement_score,
                "models_agree": consensus.models_agree,
            },
        )
        all_gates.append(gate3)
        if not gate3.passed and blocking is None:
            triggered.append(GATE_MODEL_DISAGREEMENT)
            if defect_count > 0:
                blocking = (
                    "UNSAFE",
                    f"Models disagree but defects detected. {consensus.disagreement_details}. "
                    "Conservative verdict: UNSAFE.",
                    "medium",
                    False,
                )
            else:
                blocking = (
                    "SAFE",
                    f"Models disagree but no defects found. {consensus.disagreement_details}. "
                    "Proceeding with SAFE verdict.",
                    "medium",
                    False,
                )
            logger.warning(
                f"Gate 3 FAILED: models disagree ({consensus.agreement_score:.0%})"
            )

        # Gate 4 — confidence floor -------------------------------------
        low_conf = ins_conf == "low" or aud_conf == "low"
        gate4 = GateResult(
            GATE_LOW_CONFIDENCE,
            passed=not low_conf,
            message=f"Inspector: {ins_conf}, Auditor: {aud_conf}",
            details={"inspector_confidence": ins_conf, "auditor_confidence": aud_conf},
        )
        all_gates.append(gate4)
        if not gate4.passed and blocking is None:
            triggered.append(GATE_LOW_CONFIDENCE)
            if defect_count > 0:
                blocking = (
                    "UNSAFE",
                    f"Low confidence but defects detected (Inspector: {ins_conf}, "
                    f"Auditor: {aud_conf}). Conservative verdict: UNSAFE.",
                    "low",
                    False,
                )
            else:
                blocking = (
                    "SAFE",
                    f"Low confidence but no defects found (Inspector: {ins_conf}, "
                    f"Auditor: {aud_conf}). Proceeding with SAFE verdict.",
                    "low",
                    False,
                )
            logger.warning("Gate 4 FAILED: low confidence")

        # Gate 5 — defect count cap -------------------------------------
        limit = config.max_defects_auto
        gate5 = GateResult(
            GATE_DEFECT_COUNT,
            passed=defect_count <= limit,
            message=f"{defect_count} defects (limit: {limit})",
            details={"defect_count": defect_count, "limit": limit},
        )
        all_gates.append(gate5)
        if not gate5.passed and blocking is None:
            triggered.append(GATE_DEFECT_COUNT)
            blocking = (
                "UNSAFE",
                f"Multiple defects detected ({defect_count} found, limit: {limit}) "
                "- automatically marked UNSAFE",
                "medium",
                False,
            )
            logger.warning(f"Gate 5 FAILED: {defect_count} defects over limit {limit}")

        # Gate 6 — high-criticality context -----------------------------
        high_crit_clean = context.criticality == "high" and defect_count == 0
        high_crit_dirty = (
            context.criticality == "high"
            and defect_count > 0
            and config.high_criticality_requires_review
        )
        both_high_conf = ins_conf == "high" and aud_conf == "high"
        if high_crit_clean:
            gate6_passed = both_high_conf
            gate6_message = (
                "High criticality, no defects, both models HIGH confidence - verified"
                if gate6_passed
                else "High criticality, no defects, but insufficient confidence "
                f"(Inspector: {ins_conf}, Auditor: {aud_conf})"
            )
        else:
            gate6_passed = not high_crit_dirty
            gate6_message = f"Criticality: {context.criticality}, Defects: {defect_count}"
        gate6 = GateResult(
            GATE_HIGH_CRITICALITY,
            passed=gate6_passed,
            message=gate6_message,
            details={
                "criticality": context.criticality,
                "defect_count": defect_count,
                "inspector_confidence": ins_conf,
                "auditor_confidence": aud_conf,
            },
        )
        all_gates.append(gate6)
        if not gate6_passed and blocking is None:
            triggered.append(GATE_HIGH_CRITICALITY)
            if high_crit_clean:
                blocking = (
                    "SAFE",
                    "High-criticality component with zero defects but insufficient "
                    f"confidence (Inspector: {ins_conf}, Auditor: {aud_conf}) "
                    "- proceeding with SAFE verdict",
                    "medium",
                    False,
                )
            else:
                blocking = (
                    "UNSAFE",
                    f"High-criticality component with {defect_count} defect(s) "
                    "- automatic UNSAFE verdict",
                    "high",
                    False,
                )
            logger.warning("Gate 6 FAILED: high-criticality requirement not met")

        # Gate 7 — verified clean ---------------------------------------
        invalid_bbox_types = [
            d.type for d in consensus.combined_defects if _bbox_out_of_range(d)
        ]
        has_invalid_bboxes = bool(invalid_bbox_types)
        high_agreement = consensus.agreement_score > CLEAN_AGREEMENT_FLOOR
        no_errors = gate0.passed
        no_defects = defect_count == 0
        gate7_passed = (
            no_defects
            and not has_invalid_bboxes
            and both_high_conf
            and high_agreement
            and no_errors
        )
        if no_defects and not gate7_passed:
            missing = []
            if has_invalid_bboxes:
                missing.append(
                    f"Invalid bbox coordinates detected: {', '.join(invalid_bbox_types)}"
                )
            if not both_high_conf:
                missing.append(
                    f"Both models HIGH confidence (Inspector: {ins_conf}, Auditor: {aud_conf})"
                )
            if not high_agreement:
                missing.append(
                    f"High agreement (score: {consensus.agreement_score:.2f}, required: >0.8)"
                )
            if not no_errors:
                missing.append("No analysis errors")
            gate7_message = f"No defects but missing requirements: {', '.join(missing)}"
        elif gate7_passed:
            gate7_message = (
                "No defects, valid bboxes, both HIGH confidence, high agreement, "
                "no errors - verified clean"
            )
        else:
            gate7_message = f"{defect_count} valid defects found"
        gate7 = GateResult(
            GATE_NO_DEFECTS,
            passed=gate7_passed,
            message=gate7_message,
            details={
                "defect_count": defect_count,
                "has_invalid_bboxes": has_invalid_bboxes,
                "invalid_bbox_defects": invalid_bbox_types,
                "inspector_confidence": ins_conf,
                "auditor_confidence": aud_conf,
                "both_high_confidence": both_high_conf,
                "agreement_score": consensus.agreement_score,
                "high_agreement": high_agreement,
                "no_errors": no_errors,
            },
        )
        all_gates.append(gate7)

        # Gate 8 — auditor certainty ------------------------------------
        auditor_uncertain = (
            aud_condition == "uncertain"
            or aud_conf == "low"
            or self._confidence_numeric(aud_conf) < 0.4
        )
        gate8 = GateResult(
            GATE_AUDITOR_UNCERTAIN,
            passed=not auditor_uncertain,
            message=f"Auditor condition: {aud_condition}, confidence: {aud_conf}",
            details={"auditor_condition": aud_condition, "auditor_confidence": aud_conf},
        )
        all_gates.append(gate8)
        if not gate8.passed and blocking is None:
            triggered.append(GATE_AUDITOR_UNCERTAIN)
            if defect_count > 0:
                blocking = (
                    "UNSAFE",
                    f"Auditor uncertain (condition: {aud_condition}, confidence: "
                    f"{aud_conf}) but defects detected - automatic UNSAFE verdict",
                    "low",
                    False,
                )
            else:
                blocking = (
                    "SAFE",
                    f"Auditor uncertain (condition: {aud_condition}, confidence: "
                    f"{aud_conf}) but no defects found - proceeding with SAFE verdict",
                    "low",
                    False,
                )
            logger.warning("Gate 8 FAILED: auditor uncertain")

        # Final verdict --------------------------------------------------
        if blocking is None and gate7.passed:
            triggered.append(GATE_NO_DEFECTS)
            logger.info("Gate 7 PASSED: verified clean image -> SAFE")
            return SafetyVerdict(
                verdict="SAFE",
                reason=(
                    "No defects detected by Inspector or Auditor - all safety gates "
                    "passed with HIGH confidence verification"
                ),
                requires_human=False,
                confidence_level="high",
                triggered_gates=triggered,
                errors=errors,
                defect_summary={
                    "total_defects": 0,
                    "verification_passed": True,
                    "all_gate_results": [g.to_dict() for g in all_gates],
                },
            )

        if blocking is not None:
            verdict, reason, confidence, requires_human = blocking
            return SafetyVerdict(
                verdict=verdict,
                reason=reason,
                requires_human=requires_human,
                confidence_level=confidence,
                triggered_gates=triggered,
                errors=errors,
                defect_summary={
                    "total_defects": defect_count,
                    "critical": len(critical),
                    "moderate": len(moderate),
                    "cosmetic": len(cosmetic),
                    "all_gate_results": [g.to_dict() for g in all_gates],
                },
            )

        # Default conservative path: only non-critical defects remain.
        if not critical and not moderate and cosmetic:
            if context.criticality == "high":
                triggered.append(GATE_DEFAULT_CONSERVATIVE)
                all_gates.append(
                    GateResult(
                        GATE_DEFAULT_CONSERVATIVE,
                        passed=False,
                        message=(
                            f"High criticality with {len(cosmetic)} cosmetic defects "
                            "- cosmetic only, SAFE"
                        ),
                        details={
                            "criticality": context.criticality,
                            "cosmetic_count": len(cosmetic),
                        },
                    )
                )
                logger.warning(
                    f"High criticality + {len(cosmetic)} cosmetic defects -> SAFE (cosmetic only)"
                )
                return SafetyVerdict(
                    verdict="SAFE",
                    reason=(
                        f"High-criticality component with {len(cosmetic)} cosmetic "
                        "defect(s) only - no safety impact, SAFE verdict"
                    ),
                    requires_human=False,
                    confidence_level="high" if consensus.models_agree else "medium",
                    triggered_gates=triggered,
                    errors=errors,
                    defect_summary={
                        "total_defects": defect_count,
                        "cosmetic": len(cosmetic),
                        "all_gate_results": [g.to_dict() for g in all_gates],
                    },
                )

            # Reference-parity (gates.py:724): GATE_7 is appended as a
            # "safe indicator" on the cosmetic-only SAFE path even though
            # the gate itself recorded FAIL ("N valid defects found").
            triggered.append(GATE_NO_DEFECTS)
            logger.info(
                f"Only cosmetic defects ({len(cosmetic)}) on {context.criticality} "
                "criticality -> SAFE"
            )
            return SafetyVerdict(
                verdict="SAFE",
                reason=(
                    f"Only cosmetic defects detected ({len(cosmetic)}). No safety impact."
                ),
                requires_human=False,
                confidence_level="high" if consensus.models_agree else "medium",
                triggered_gates=triggered,
                errors=errors,
                defect_summary={
                    "total_defects": defect_count,
                    "cosmetic": len(cosmetic),
                    "all_gate_results": [g.to_dict() for g in all_gates],
                },
            )

        triggered.append(GATE_DEFAULT_CONSERVATIVE)
        all_gates.append(
            GateResult(
                GATE_DEFAULT_CONSERVATIVE,
                passed=False,
                message=(
                    f"Conservative: {len(moderate)} moderate, {len(cosmetic)} cosmetic defects"
                ),
                details={"moderate": len(moderate), "cosmetic": len(cosmetic)},
            )
        )
        # Parity note: a zero-defect result that failed gate 7 (agreement
        # 0.7-0.8 with both models confident) reaches this branch and is
        # returned UNSAFE with "0 unclassified defect(s)" — the reference
        # behaves identically (reference gates.py:742-775) and the verdict
        # contract is bit-exact, so this stays.
        severity_msg = (
            f"{len(moderate)} MODERATE" if moderate else f"{defect_count} unclassified"
        )
        logger.warning(f"Default gate (CONSERVATIVE): {severity_msg} defects -> UNSAFE")
        listed = ", ".join(d.type for d in defects[:3]) + ("..." if len(defects) > 3 else "")
        return SafetyVerdict(
            verdict="UNSAFE",
            reason=f"Defects detected: {severity_msg} defect(s). Types: {listed}",
            requires_human=False,
            confidence_level="high" if consensus.models_agree else "medium",
            triggered_gates=triggered,
            errors=errors,
            defect_summary={
                "total_defects": defect_count,
                "moderate": len(moderate),
                "cosmetic": len(cosmetic),
                "defect_types": [d.type for d in defects],
                "all_gate_results": [g.to_dict() for g in all_gates],
            },
        )


def evaluate_safety(consensus: ConsensusResult, context: InspectionContext) -> SafetyVerdict:
    """Evaluate all deterministic safety gates (reference gates.py:778)."""
    return SafetyGateEngine().evaluate(consensus, context)


__all__ = [
    "GATE_ERROR_STATE",
    "GATE_CRITICAL_DEFECT",
    "GATE_DOMAIN_ZERO_TOLERANCE",
    "GATE_MODEL_DISAGREEMENT",
    "GATE_LOW_CONFIDENCE",
    "GATE_DEFECT_COUNT",
    "GATE_HIGH_CRITICALITY",
    "GATE_NO_DEFECTS",
    "GATE_AUDITOR_UNCERTAIN",
    "GATE_DEFAULT_CONSERVATIVE",
    "GATE_DISPLAY_NAMES",
    "GateResult",
    "SafetyGateEngine",
    "evaluate_safety",
    "load_safety_rules",
]
