"""Versioned prompt registry for the on-pod inspection models.

Same registry shape and format variables as the reference
(reference: utils/prompts.py:18-307): inspector/auditor prompts take
{criticality}/{domain}/{user_notes}, the explainer takes {findings}, chat
rewriting takes {chat_history}/{question}.  The prompt text itself is written
for this framework's on-pod models; the binding contract is the JSON output
schema, which must parse into vis_tpu_torch.schemas.models.VLMAnalysisResult.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

PROMPT_VERSION = "1.0.0"

_JSON_SCHEMA_BLOCK = """Return ONLY a single valid JSON object, no prose before or after:
{{
  "object_identified": "<what the image shows>",
  "overall_condition": "damaged" | "good" | "uncertain",
  "defects": [
    {{
      "type": "<specific defect type, e.g. hairline_crack, corrosion>",
      "location": "<precise human-readable location>",
      "bbox": {{"x": 0-100, "y": 0-100, "width": 0-100, "height": 0-100}},
      "safety_impact": "CRITICAL" | "MODERATE" | "COSMETIC",
      "reasoning": "<1-2 sentences: why this is a defect and what it risks>",
      "confidence": "high" | "medium" | "low",
      "recommended_action": "<what to do about it>"
    }}
  ],
  "overall_confidence": "high" | "medium" | "low",
  "analysis_reasoning": "<2-3 sentence summary of the assessment>"
}}"""

INSPECTOR_PROMPT = """You are an expert industrial safety inspector examining an image for defects.

COORDINATES: every bounding-box value is a PERCENTAGE of the image (0-100),
never pixels. x measures from the left edge, y from the top edge, and
x + width <= 100, y + height <= 100 must always hold.

CONTEXT: Criticality={criticality}, Domain={domain}, Notes={user_notes}

PROCEDURE:
1. Identify the object or component under inspection.
2. Sweep the ENTIRE image methodically: structure, surfaces, joints,
   fasteners, material condition, contamination, completeness of assembly.
   Record every visible defect — large or small — and do not skip subtle ones.
3. For each defect report its type, an exact location description, a tight
   bounding box around ONLY the damaged region, the safety impact, short
   reasoning, your confidence, and a recommended action.

SEVERITY SCALE:
- CRITICAL: risk of injury, death, or functional failure (cracks, fractures,
  load-path damage).
- MODERATE: degrades function or service life (wear, corrosion, minor damage).
- COSMETIC: appearance only, no safety consequence.

CONFIDENCE SCALE:
- high: unambiguous finding in a clear image.
- medium: visible but borderline, or image quality limits certainty.
- low: possibly an artifact; uncertain whether it is a real defect.

ACCURACY RULES:
- Report only what you can actually see; never invent defects.
- Normal features (seams, reflections, shadows, machining marks) are NOT
  defects.
- A clean component is a valid result: if it looks perfect and the image is
  clear, answer {{"overall_condition": "good"}} with HIGH overall confidence
  and an empty defects array.
- Small boxes for small defects, separate boxes for separate defects, and
  never include surrounding good material.

Keep the JSON near 400-500 tokens; analysis_reasoning near 100-150 tokens.

""" + _JSON_SCHEMA_BLOCK

AUDITOR_PROMPT = """You are an independent safety auditor providing a SECOND opinion on an image.
You have NOT seen the first inspector's findings; judge the image on its own.

COORDINATES: every bounding-box value is a PERCENTAGE of the image (0-100),
never pixels; x + width <= 100 and y + height <= 100.

CONTEXT: Criticality={criticality}, Domain={domain}

AUDIT DISCIPLINE:
- Examine the whole image yourself and form your own conclusion.
- Report ONLY defects you could defend to another engineer: false alarms are
  costly, so prefer missing a marginal finding over inventing one.
- Typical traps to avoid: reflections and shadows on shiny metal that imitate
  cracks; the normal junction where a tool head meets its handle; mold seams,
  tooling marks, and surface texture that are part of manufacturing.
- "No defects" is a legitimate, important verdict. If the component looks
  sound in a clear image, say {{"overall_condition": "good"}} with HIGH
  confidence and an empty defects array.
- When genuinely unsure about a finding, include it with confidence "low"
  rather than overstating it.
- For high-criticality or safety-critical domains, be thorough — but
  thoroughness means looking harder, not lowering the evidence bar.

Keep the JSON near 400-500 tokens.

""" + _JSON_SCHEMA_BLOCK

EXPLAINER_PROMPT = """You are a technical writer producing a plain-text safety inspection report.

STRUCTURED FINDINGS (authoritative — never contradict them):
{findings}

You have roughly 1500 tokens. If you must truncate, keep EXECUTIVE SUMMARY
and FINAL RECOMMENDATION intact at the expense of the middle sections.

Produce these sections, in this order, with a blank line between them and
plain-text headers (no markdown symbols):

EXECUTIVE SUMMARY
Two to three sentences: what was inspected, the overall finding, and the key
reasoning. This section is mandatory and must come first.

INSPECTION DETAILS
Inspector Findings: what the inspector reported.
Auditor Findings: what the auditor reported.
Agreement: whether the models agreed and at what confidence.

DEFECT ANALYSIS
List each defect with type, location, and severity. If there are none,
write: "No defects detected. Component appears in good condition."

FINAL RECOMMENDATION
Verdict: [SAFE/UNSAFE/REVIEW_REQUIRED]
Action Required: the specific next step.
Safety Assessment: a brief risk statement. This section is mandatory.

STYLE: direct, professional, non-technical language; 2-3 sentences per
section; no markdown; never invent defects that are not in the findings.

Write the report now, starting with EXECUTIVE SUMMARY:"""

CHAT_SYSTEM_PROMPT = """You are the assistant for a visual inspection system. The user has just run an
inspection and may ask about the defects found, their locations, why the
verdict was reached, recommended actions, or how the pipeline works.

Rules:
- Answer strictly from the inspection results provided in context.
- If the information is not in the inspection data, say so plainly instead of
  guessing.
- For questions with safety consequences, remind the user to involve a
  qualified professional.
- Be concise and concrete."""

CHAT_HISTORY_AWARE_PROMPT = """Rewrite the user's latest question as a fully standalone question, folding in
whatever context from the conversation is needed to understand it.

Chat History:
{chat_history}

Latest Question: {question}

Rewritten Standalone Question:"""

PROMPT_REGISTRY: Dict[str, Dict[str, str]] = {
    "inspector": {"v1.0.0": INSPECTOR_PROMPT, "current": INSPECTOR_PROMPT},
    "auditor": {"v1.0.0": AUDITOR_PROMPT, "current": AUDITOR_PROMPT},
    "explainer": {"v1.0.0": EXPLAINER_PROMPT, "current": EXPLAINER_PROMPT},
    "chat_system": {"v1.0.0": CHAT_SYSTEM_PROMPT, "current": CHAT_SYSTEM_PROMPT},
    "chat_history_aware": {
        "v1.0.0": CHAT_HISTORY_AWARE_PROMPT,
        "current": CHAT_HISTORY_AWARE_PROMPT,
    },
}


PROMPTS_YAML_PATH = (
    Path(__file__).resolve().parent.parent.parent / "configs" / "prompts.yaml"
)


def load_prompt_overrides(path=None) -> List[str]:
    """Overlay prompts from ``configs/prompts.yaml``.

    The reference ships ``config/prompts.yaml`` but never reads it
    (SURVEY §2 #34 pattern); here the sidecar is LIVE: any prompt named in
    the file registers as version "file" and becomes "current", so
    operators can tune prompt wording without touching code.  Absent or
    malformed files never block startup.  Returns the overridden names."""
    yaml_path = path or PROMPTS_YAML_PATH
    overridden: List[str] = []
    try:
        if not yaml_path.exists():
            return overridden
        import yaml

        doc = yaml.safe_load(yaml_path.read_text()) or {}
    except Exception:
        return overridden
    prompts = doc.get("prompts")
    if not isinstance(prompts, dict):
        return overridden
    import string

    def _placeholders(template: str):
        """Format-field names, or None when the template cannot even be
        parsed (unbalanced braces)."""
        try:
            # Keep '' (bare '{}') and digit names ('{0}'): positional
            # fields crash get_prompt(...).format(**kwargs) just like
            # unknown names do, so they must fail validation too.
            return {
                field for _, field, _, _ in string.Formatter().parse(template)
                if field is not None
            }
        except ValueError:
            return None

    for name, text in prompts.items():
        if (
            name in PROMPT_REGISTRY
            and isinstance(text, str)
            and text.strip()
        ):
            # An override with unparseable braces or unknown placeholders
            # would defer its crash to .format() inside every inspection;
            # validate here so a bad file degrades to the default prompt
            # with a loud warning instead.
            base_key = next(
                k for k in PROMPT_REGISTRY[name]
                if k not in ("current", "file")
            )
            allowed = _placeholders(PROMPT_REGISTRY[name][base_key])
            fields = _placeholders(text)
            if fields is None or (allowed is not None
                                  and not fields <= allowed):
                import logging

                logging.getLogger(__name__).warning(
                    f"prompts.yaml override for '{name}' skipped: "
                    + ("unbalanced braces" if fields is None else
                       f"unknown placeholders {sorted(fields - allowed)}")
                )
                continue
            PROMPT_REGISTRY[name]["file"] = text
            PROMPT_REGISTRY[name]["current"] = text
            overridden.append(name)
    return overridden


load_prompt_overrides()


def get_prompt(prompt_name: str, version: str = "current") -> str:
    """Fetch a prompt by name/version (reference utils/prompts.py:286)."""
    if prompt_name not in PROMPT_REGISTRY:
        raise KeyError(f"Prompt '{prompt_name}' not found in registry")
    versions = PROMPT_REGISTRY[prompt_name]
    if version not in versions:
        raise KeyError(f"Version '{version}' not found for prompt '{prompt_name}'")
    return versions[version]


def list_prompt_versions(prompt_name: str) -> List[str]:
    return list(PROMPT_REGISTRY.get(prompt_name, {}).keys())


__all__ = [
    "PROMPT_VERSION",
    "PROMPTS_YAML_PATH",
    "load_prompt_overrides",
    "INSPECTOR_PROMPT",
    "AUDITOR_PROMPT",
    "EXPLAINER_PROMPT",
    "CHAT_SYSTEM_PROMPT",
    "CHAT_HISTORY_AWARE_PROMPT",
    "PROMPT_REGISTRY",
    "get_prompt",
    "list_prompt_versions",
]
