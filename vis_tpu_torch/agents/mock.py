"""Deterministic mock inference backend.

Implements the USE_MOCK_RESPONSES capability the reference declared but never
wired up (reference: utils/config.py:191, SURVEY.md §4 item 2): a fake
backend returning canned, schema-valid model output so the entire pipeline
(graph -> consensus -> gates -> DB -> PDF) runs hermetically with no devices
or weights.

Scenario selection is deterministic per image: an explicit `scenario` wins,
else a scenario hint embedded in the filename (e.g. "crack", "clean"), else a
stable hash of the file bytes picks from the rotation.  Fault injection is
supported via `fail_every` for exercising the retry/Gate-0 paths.
"""

from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Optional

_CLEAN = {
    "object_identified": "metal component",
    "overall_condition": "good",
    "defects": [],
    "overall_confidence": "high",
    "analysis_reasoning": (
        "The component surface is uniform with no visible cracks, corrosion or "
        "deformation. Edges and fasteners appear intact. Image quality is "
        "sufficient for a confident assessment."
    ),
}

_CRITICAL = {
    "object_identified": "metal bracket",
    "overall_condition": "damaged",
    "defects": [
        {
            "type": "crack",
            "location": "center of the load-bearing arm",
            "bbox": {"x": 42.0, "y": 35.0, "width": 14.0, "height": 6.0},
            "safety_impact": "CRITICAL",
            "reasoning": "A through-crack crosses the load path and can propagate under cyclic load.",
            "confidence": "high",
            "recommended_action": "Remove from service and replace immediately.",
        }
    ],
    "overall_confidence": "high",
    "analysis_reasoning": (
        "A clearly visible crack crosses the main structural member. The crack "
        "edges are sharp and continuous, ruling out a surface scratch."
    ),
}

_MODERATE = {
    "object_identified": "steel plate",
    "overall_condition": "damaged",
    "defects": [
        {
            "type": "corrosion",
            "location": "lower right quadrant near the mounting hole",
            "bbox": {"x": 62.0, "y": 58.0, "width": 18.0, "height": 16.0},
            "safety_impact": "MODERATE",
            "reasoning": "Surface corrosion is consuming material around the fastener hole.",
            "confidence": "high",
            "recommended_action": "Clean, treat and monitor at next service interval.",
        }
    ],
    "overall_confidence": "high",
    "analysis_reasoning": (
        "Localized corrosion is visible around the lower fastener. No cracking "
        "observed; structural section is otherwise sound."
    ),
}

_COSMETIC = {
    "object_identified": "painted panel",
    "overall_condition": "damaged",
    "defects": [
        {
            "type": "scratch",
            "location": "upper left corner of the panel face",
            "bbox": {"x": 8.0, "y": 6.0, "width": 10.0, "height": 2.0},
            "safety_impact": "COSMETIC",
            "reasoning": "A shallow scratch in the paint layer with no substrate exposure.",
            "confidence": "high",
            "recommended_action": "Touch up paint if appearance matters.",
        }
    ],
    "overall_confidence": "high",
    "analysis_reasoning": "Only superficial paint damage is present; the panel itself is intact.",
}

_UNCERTAIN = {
    "object_identified": "machined part",
    "overall_condition": "uncertain",
    "defects": [],
    "overall_confidence": "medium",
    "analysis_reasoning": (
        "Lighting and focus limit the assessment; no defects are clearly "
        "visible but a marginal region near the edge cannot be resolved."
    ),
}

SCENARIOS: Dict[str, Dict[str, Any]] = {
    "clean": _CLEAN,
    "critical": _CRITICAL,
    "moderate": _MODERATE,
    "cosmetic": _COSMETIC,
    "uncertain": _UNCERTAIN,
}

_FILENAME_HINTS = (
    ("crack", "critical"),
    ("critical", "critical"),
    ("rust", "moderate"),
    ("corrosion", "moderate"),
    ("moderate", "moderate"),
    ("scratch", "cosmetic"),
    ("cosmetic", "cosmetic"),
    ("uncertain", "uncertain"),
    ("blur", "uncertain"),
    ("clean", "clean"),
    ("good", "clean"),
)

_ROTATION = ("clean", "critical", "moderate", "cosmetic", "uncertain")


def _pick_scenario(image_path: Optional[Path]) -> str:
    if image_path is None:
        return "clean"
    name = Path(image_path).name.lower()
    for needle, scenario in _FILENAME_HINTS:
        if needle in name:
            return scenario
    try:
        digest = hashlib.md5(Path(image_path).read_bytes()).digest()
        return _ROTATION[digest[0] % len(_ROTATION)]
    except OSError:
        return "clean"


def _mock_explanation(findings: str) -> str:
    verdict = "UNKNOWN"
    defect_line = "No defects detected. Component appears in good condition."
    try:
        payload = json.loads(findings) if findings.strip().startswith("{") else {}
        verdict = payload.get("verdict", {}).get("verdict", "UNKNOWN")
        defects = payload.get("inspector", {}).get("defects", [])
        if defects:
            defect_line = "; ".join(
                f"{d.get('type')} at {d.get('location')} ({d.get('safety_impact')})"
                for d in defects
            )
    except Exception:
        pass
    return f"""EXECUTIVE SUMMARY

The submitted component was inspected independently by two vision models and
scored by the deterministic consensus and safety-gate engine. Final verdict:
{verdict}.

INSPECTION DETAILS

Inspector Findings: see defect analysis below.
Auditor Findings: independent second assessment of the same image.
Agreement: the models' findings were compared by the consensus engine.

DEFECT ANALYSIS

{defect_line}

FINAL RECOMMENDATION

Verdict: {verdict}
Action Required: {"No action required" if verdict == "SAFE" else "Follow the recommended actions for each defect"}
Safety Assessment: {"The component appears safe for continued use." if verdict == "SAFE" else "The component requires attention before continued use."}"""


_DECISION_SUPPORT = {
    "repair_cost_min": 40,
    "repair_cost_max": 180,
    "replace_cost_estimate": 650,
    "repair_time_estimate": "2-4 hours",
    "replace_lead_time": "3-5 days",
    "recommendation": "REPAIR",
    "reasoning": "Localized damage is economically repairable versus full replacement.",
}


class MockVLMBackend:
    """Schema-valid canned responses with optional fault injection."""

    def __init__(
        self,
        scenario: Optional[str] = None,
        fail_every: int = 0,
        latency_s: float = 0.0,
    ):
        if scenario is not None and scenario not in SCENARIOS:
            raise ValueError(f"unknown scenario {scenario!r}; options: {list(SCENARIOS)}")
        self.name = "mock"
        self.scenario = scenario
        self.fail_every = fail_every
        self.latency_s = latency_s
        self._calls = 0

    def generate(
        self,
        prompt: str,
        image_path: Optional[Path] = None,
        *,
        max_tokens: int = 1024,
        temperature: float = 0.0,
        max_image_dim: int = 2048,
        json_mode: bool = False,
        json_schema: Optional[str] = None,
        schema_batched: bool = False,
        min_tokens: Optional[int] = None,
    ) -> str:
        self._calls += 1
        if self.fail_every and self._calls % self.fail_every == 0:
            raise RuntimeError("injected mock backend failure")
        if self.latency_s:
            time.sleep(self.latency_s)

        if "repair cost estimator" in prompt or "repair_cost_min" in prompt:
            return json.dumps(_DECISION_SUPPORT)
        if "Rewritten Standalone Question" in prompt:
            return prompt.rsplit("Latest Question:", 1)[-1].split("\n")[0].strip()
        if "STRUCTURED FINDINGS" in prompt and image_path is None:
            findings = ""
            marker = "STRUCTURED FINDINGS"
            if marker in prompt:
                after = prompt.split(marker, 1)[1]
                brace = after.find("{")
                if brace != -1:
                    findings = after[brace:].split("\n\nCRITICAL", 1)[0]
                    findings = findings.rsplit("\n\nYou have roughly", 1)[0]
            return _mock_explanation(findings)
        if "COUNTERFACTUAL" in prompt or "would have changed the verdict" in prompt:
            return (
                "Had the detected defects been absent, the clean-verification "
                "path would have applied and the verdict would likely have "
                "been SAFE. Conversely, any additional critical defect would "
                "have triggered Gate 1 and forced UNSAFE regardless of model "
                "agreement."
            )
        if image_path is None:
            # Generic text request (health checks, chat).
            if "'OK'" in prompt or '"OK"' in prompt:
                return "OK"
            return (
                "Based on the inspection results in context, the component's "
                "verdict and defect details are summarized above. Let me know if "
                "you need the location or severity of a specific finding."
            )

        if "failparse" in Path(image_path).name.lower():
            # Test hook: unparseable model output end-to-end (drives the
            # robust-parse failure -> Gate 0 -> human review path without
            # monkeypatching, e.g. through the HTTP surface).
            return "GARBLED <<<not json at all>>>"
        scenario = self.scenario or _pick_scenario(image_path)
        return json.dumps(SCENARIOS[scenario])

    def generate_stream(
        self,
        prompt: str,
        image_path: Optional[Path] = None,
        *,
        max_tokens: int = 1024,
        temperature: float = 0.0,
        max_image_dim: int = 2048,
        json_mode: bool = False,
        json_schema: Optional[str] = None,
        schema_batched: bool = False,
        min_tokens: Optional[int] = None,
    ) -> Iterator[str]:
        text = self.generate(
            prompt,
            image_path,
            max_tokens=max_tokens,
            temperature=temperature,
            max_image_dim=max_image_dim,
        )
        # Stream in word-ish chunks to exercise token-streaming consumers.
        for i in range(0, len(text), 24):
            yield text[i : i + 24]

    def health_check(self) -> bool:
        return True


__all__ = ["MockVLMBackend", "SCENARIOS"]
