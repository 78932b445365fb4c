"""Inspector agent: primary defect analysis over an on-pod vision-language
model (reference: src/agents/vlm_inspector.py:23-558, with the HuggingFace
InferenceClient transport replaced by an in-process CUDA engine backend).

`analyze()` never raises: any failure becomes a VLMAnalysisResult with
analysis_failed=True so the pipeline's Gate 0 handles it deterministically.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

from vis_tpu_torch.agents.base import BaseVLMAgent, InferenceBackend
from vis_tpu_torch.schemas.models import InspectionContext, VLMAnalysisResult
from vis_tpu_torch.utils.config import config
from vis_tpu_torch.utils.prompts import get_prompt


class VLMInspectorAgent(BaseVLMAgent):
    component = "INSPECTOR"

    def __init__(self, backend: InferenceBackend):
        super().__init__(
            backend,
            model_name=config.vlm_inspector_model,
            temperature=config.vlm_inspector_temperature,
            max_tokens=config.vlm_inspector_max_tokens,
        )
        self.max_image_dim = config.max_image_dimension

    def analyze(
        self, image_path: Path, context: InspectionContext
    ) -> VLMAnalysisResult:
        """Run the inspector model over one image and return a repaired,
        schema-valid result."""
        start = time.perf_counter()
        prompt = get_prompt("inspector").format(
            criticality=context.criticality,
            domain=context.domain or "general",
            user_notes=context.user_notes or "none",
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
                min_tokens=config.vlm_inspector_min_tokens,
            )
            parsed = self._parse_json_robust(raw)
            fixed = self._validate_and_fix_result(parsed)
            result = VLMAnalysisResult(**fixed)
            elapsed = time.perf_counter() - start
            self.logger.info(
                f"Inspector ({self.backend.name}) finished in {elapsed:.2f}s: "
                f"{len(result.defects)} defects, condition="
                f"{result.overall_condition}"
            )
            return result
        except Exception as exc:
            self.logger.error(f"Inspector analysis failed: {exc}")
            return VLMAnalysisResult(
                object_identified="unknown",
                overall_condition="uncertain",
                defects=[],
                overall_confidence="low",
                analysis_reasoning=f"Analysis failed: {exc}",
                analysis_failed=True,
                failure_reason=str(exc),
            )

    def health_check(self) -> bool:
        ok = super().health_check()
        if ok:
            self.logger.info(f"Inspector backend '{self.backend.name}' healthy")
        return ok


# Short alias kept for API parity with the reference (vlm_inspector.py:558).
InspectorAgent = VLMInspectorAgent

__all__ = ["VLMInspectorAgent", "InspectorAgent"]
