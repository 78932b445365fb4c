"""Auditor agent: independent second-opinion analysis
(reference: src/agents/vlm_auditor.py:22-532, with the Groq/HF provider chain
replaced by an in-process CUDA engine backend).

Independence is the core property: `verify()` receives the inspector result
for interface parity but never feeds it to the model (reference
vlm_auditor.py:187) — the consensus engine needs two uncorrelated opinions.
Images are capped at a smaller resolution than the inspector's (1024px), as
in the reference (vlm_auditor.py:85).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

from vis_tpu_torch.agents.base import BaseVLMAgent, InferenceBackend
from vis_tpu_torch.schemas.models import InspectionContext, VLMAnalysisResult
from vis_tpu_torch.utils.config import config
from vis_tpu_torch.utils.prompts import get_prompt


class VLMAuditorAgent(BaseVLMAgent):
    component = "AUDITOR"

    def __init__(self, backend: InferenceBackend):
        super().__init__(
            backend,
            model_name=config.vlm_auditor_model,
            temperature=config.vlm_auditor_temperature,
            max_tokens=config.vlm_auditor_max_tokens,
        )
        self.max_image_dim = config.auditor_max_image_dimension

    def verify(
        self,
        image_path: Path,
        context: InspectionContext,
        inspector_result: Optional[VLMAnalysisResult] = None,
    ) -> VLMAnalysisResult:
        """Independent verification; `inspector_result` is intentionally unused
        in the prompt."""
        start = time.perf_counter()
        prompt = get_prompt("auditor").format(
            criticality=context.criticality,
            domain=context.domain or "general",
        )
        try:
            raw = self.backend.generate(
                prompt,
                Path(image_path),
                max_tokens=self.max_tokens,
                temperature=self.temperature,
                max_image_dim=self.max_image_dim,
                json_mode=config.constrained_json or config.constrained_schema,
                json_schema=(
                    "inspection" if config.constrained_schema else None
                ),
                min_tokens=config.vlm_auditor_min_tokens,
            )
            parsed = self._parse_json_robust(raw)
            fixed = self._validate_and_fix_result(parsed)
            result = VLMAnalysisResult(**fixed)
            elapsed = time.perf_counter() - start
            self.logger.info(
                f"Auditor ({self.backend.name}) finished in {elapsed:.2f}s: "
                f"{len(result.defects)} defects, condition="
                f"{result.overall_condition}"
            )
            return result
        except Exception as exc:
            self.logger.error(f"Auditor verification failed: {exc}")
            return VLMAnalysisResult(
                object_identified="unknown",
                overall_condition="uncertain",
                defects=[],
                overall_confidence="low",
                analysis_reasoning=f"Verification failed: {exc}",
                analysis_failed=True,
                failure_reason=str(exc),
            )


AuditorAgent = VLMAuditorAgent

__all__ = ["VLMAuditorAgent", "AuditorAgent"]
