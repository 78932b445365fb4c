"""Explainer agent: report narration, decision support, and chat
(reference: src/agents/explainer.py:15-355, with the Groq text-LLM transport
replaced by an in-process CUDA engine backend with streaming decode).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterator, List, Optional

from vis_tpu_torch.agents.base import BaseVLMAgent, InferenceBackend
from vis_tpu_torch.schemas.models import VLMAnalysisResult
from vis_tpu_torch.utils.config import config
from vis_tpu_torch.utils.prompts import get_prompt


def _json_default(obj: Any) -> str:
    if hasattr(obj, "isoformat"):
        return obj.isoformat()
    return str(obj)


_DECISION_SUPPORT_PROMPT = """You are a repair cost estimator. Based on the following defects, estimate
repair vs replace costs in US DOLLARS.

DEFECTS:
{defects}

VERDICT: {verdict}

Output ONLY a valid JSON object with exactly these keys:
- repair_cost_min: number (USD)
- repair_cost_max: number (USD)
- replace_cost_estimate: number (USD)
- repair_time_estimate: string (e.g. "2-4 hours")
- replace_lead_time: string (e.g. "3-5 days")
- recommendation: "REPAIR" or "REPLACE"
- reasoning: string (one brief sentence)

Use realistic market rates for standard industrial components."""


class ExplainerAgent(BaseVLMAgent):
    component = "EXPLAINER"

    def __init__(self, backend: InferenceBackend):
        super().__init__(
            backend,
            model_name=config.explainer_model,
            temperature=config.explainer_temperature,
            max_tokens=config.explainer_max_tokens,
        )
        import threading as _threading
        from collections import OrderedDict

        self._chat_sessions: "OrderedDict" = OrderedDict()
        self._chat_lock = _threading.Lock()

    def _call_llm(self, prompt: str, json_mode: bool = False,
                  max_tokens: Optional[int] = None,
                  json_schema: Optional[str] = None,
                  schema_batched: bool = False) -> str:
        use_json = json_mode and (
            config.constrained_json or config.constrained_schema
        )
        return self.backend.generate(
            prompt, None, max_tokens=max_tokens or self.max_tokens,
            temperature=self.temperature,
            json_mode=use_json,
            json_schema=(
                json_schema
                if use_json and config.constrained_schema else None
            ),
            schema_batched=schema_batched,
        )

    def _format_reasoning_chain(
        self,
        inspector_result: VLMAnalysisResult,
        auditor_result: VLMAnalysisResult,
    ) -> str:
        """Numbered dual-chain summary for prompts/reports
        (reference explainer.py:133-165)."""
        lines = ["INSPECTOR ANALYSIS:"]
        lines.append(f"1. Object identified: {inspector_result.object_identified}")
        lines.append(f"2. Overall condition: {inspector_result.overall_condition}")
        lines.append(f"3. Defects found: {len(inspector_result.defects)}")
        for i, d in enumerate(inspector_result.defects[:3], 1):
            lines.append(f"   {i}. {d.type} at {d.location} -> {d.safety_impact}")
        lines.append(f"4. Confidence: {inspector_result.overall_confidence}")
        lines.append("")
        lines.append("AUDITOR VERIFICATION:")
        lines.append(f"1. Object confirmed: {auditor_result.object_identified}")
        lines.append(f"2. Condition assessment: {auditor_result.overall_condition}")
        lines.append(f"3. Defects verified: {len(auditor_result.defects)}")
        for i, d in enumerate(auditor_result.defects[:3], 1):
            lines.append(f"   {i}. {d.type} -> {d.safety_impact}")
        lines.append(f"4. Confidence: {auditor_result.overall_confidence}")
        return "\n".join(lines)

    def generate_explanation(
        self,
        inspector_result: VLMAnalysisResult,
        auditor_result: VLMAnalysisResult,
        consensus: Dict[str, Any],
        safety_verdict: Dict[str, Any],
    ) -> str:
        """Narrate the structured findings into the sectioned report text."""
        findings = {
            "inspector": {
                "object": inspector_result.object_identified,
                "condition": inspector_result.overall_condition,
                "defects": [
                    {
                        "type": d.type,
                        "location": d.location,
                        "safety_impact": d.safety_impact,
                        "reasoning": d.reasoning,
                    }
                    for d in inspector_result.defects
                ],
                "confidence": inspector_result.overall_confidence,
            },
            "auditor": {
                "object": auditor_result.object_identified,
                "condition": auditor_result.overall_condition,
                "defects": [
                    {
                        "type": d.type,
                        "location": d.location,
                        "safety_impact": d.safety_impact,
                    }
                    for d in auditor_result.defects
                ],
                "confidence": auditor_result.overall_confidence,
            },
            "consensus": consensus,
            "verdict": safety_verdict,
        }
        findings_str = json.dumps(findings, indent=2, default=_json_default)
        prompt = get_prompt("explainer").format(findings=findings_str)
        try:
            explanation = self._call_llm(prompt)
            return explanation.strip()
        except Exception as exc:
            self.logger.error(f"Explanation generation failed: {exc}")
            return (
                f"Inspection complete. The system detected "
                f"{len(inspector_result.defects)} defects. Final verdict: "
                f"{safety_verdict.get('verdict', 'UNKNOWN')}. Please review the "
                "detailed findings in the report."
            )

    def generate_report_bundle(
        self,
        inspector_result: VLMAnalysisResult,
        auditor_result: VLMAnalysisResult,
        consensus: Dict[str, Any],
        safety_verdict: Dict[str, Any],
    ):
        """Run the report's three INDEPENDENT decodes concurrently on the
        shared text engine: narration, counterfactual, and decision support
        have no data dependencies between them, so submitting them together
        lets the engine's continuous-batching scheduler share every decode
        step's weight reads (~2.6x measured at this batch width on the int4
        target config) instead of paying three sequential full-weight
        decodes — the reference runs its explainer calls strictly
        sequentially (reference src/orchestration/nodes.py:557-668).

        Greedy rows are token-exact in mixed batches, so the outputs are
        identical to the sequential calls (tests/test_scheduled_engine.py
        pins this).  Without an attached scheduler the engine lock simply
        serializes the three calls — same outputs, sequential timing.

        Returns (explanation, counterfactual, decision_support); the
        counterfactual is generated unconditionally here (its decode is
        nearly free when batched) and the caller appends it only when the
        narration lacks the section."""
        import concurrent.futures

        defects = consensus.get("combined_defects", [])
        verdict_str = safety_verdict.get("verdict", "UNKNOWN")
        with concurrent.futures.ThreadPoolExecutor(max_workers=3) as pool:
            f_narration = pool.submit(
                self.generate_explanation,
                inspector_result, auditor_result, consensus, safety_verdict,
            )
            f_counterfactual = pool.submit(
                self.generate_counterfactual, inspector_result, safety_verdict
            )
            f_decision = pool.submit(
                self.generate_decision_support, defects, verdict_str,
                schema_batched=True,
            )
            return (
                f_narration.result(),
                f_counterfactual.result(),
                f_decision.result(),
            )

    def generate_decision_support(
        self, defects: List[Any], verdict: str, schema_batched: bool = False
    ) -> Dict[str, Any]:
        """Repair-vs-replace cost/time estimate (reference explainer.py:264-338)."""
        if not defects:
            return {
                "repair_cost": "$0",
                "replace_cost": "N/A",
                "repair_time": "N/A",
                "replace_time": "N/A",
                "recommendation": "No Action Required",
                "reasoning": "No defects detected.",
            }

        def _get(d: Any, key: str, default: str) -> str:
            if isinstance(d, dict):
                return d.get(key, default)
            return getattr(d, key, default)

        defect_summary = json.dumps(
            [
                {
                    "type": _get(d, "type", "unknown"),
                    "severity": _get(d, "safety_impact", "MODERATE"),
                    "location": _get(d, "location", "unspecified"),
                }
                for d in defects
            ],
            indent=2,
        )
        prompt = _DECISION_SUPPORT_PROMPT.format(defects=defect_summary, verdict=verdict)
        try:
            # Small fixed-shape JSON (7 fields) — cap the decode budget.
            response = self._call_llm(
                prompt, json_mode=True, max_tokens=min(256, self.max_tokens),
                json_schema="decision_support",
                schema_batched=schema_batched,
            ).strip()
            if "```json" in response:
                response = response.split("```json")[1].split("```")[0].strip()
            elif "```" in response:
                response = response.split("```")[1].split("```")[0].strip()
            data = json.loads(response)
            return {
                "repair_cost": f"${data.get('repair_cost_min', 0):,} - ${data.get('repair_cost_max', 0):,}",
                "replace_cost": f"${data.get('replace_cost_estimate', 0):,}",
                "repair_time": data.get("repair_time_estimate", "Unknown"),
                "replace_time": data.get("replace_lead_time", "Unknown"),
                "recommendation": data.get("recommendation", "Review"),
                "reasoning": data.get("reasoning", ""),
            }
        except Exception as exc:
            self.logger.error(f"Decision support generation failed: {exc}")
            return {
                "repair_cost": "N/A",
                "replace_cost": "N/A",
                "repair_time": "N/A",
                "replace_time": "N/A",
                "recommendation": "Manual Review Required",
                "reasoning": "Could not generate estimates.",
            }

    def generate_counterfactual(
        self,
        inspector_result: VLMAnalysisResult,
        safety_verdict: Dict[str, Any],
    ) -> str:
        """What-if analysis: how would the verdict change if key findings
        were different?  (The reference defined this but never wired it in —
        reference explainer.py:97; here it feeds the report's COUNTERFACTUAL
        section.)"""
        defects = inspector_result.defects
        verdict = safety_verdict.get("verdict", "UNKNOWN")
        if not defects:
            prompt = (
                "In 2-3 sentences, explain what kinds of defects, had they "
                f"been present on this {inspector_result.object_identified}, "
                "would have changed the verdict from "
                f"{verdict} to UNSAFE, and why."
            )
        else:
            listed = "; ".join(
                f"{d.type} ({d.safety_impact}) at {d.location}" for d in defects[:3]
            )
            prompt = (
                "COUNTERFACTUAL ANALYSIS: In 2-3 sentences, explain how the "
                f"verdict ({verdict}) would change if these defects were "
                f"absent or less severe: {listed}."
            )
        try:
            # The prompt asks for 2-3 sentences; cap the decode accordingly
            # instead of paying the full report budget.
            return self._call_llm(
                prompt, max_tokens=min(192, self.max_tokens)
            ).strip()
        except Exception as exc:
            self.logger.warning(f"Counterfactual generation failed: {exc}")
            return ""

    def chat(self, system_context: str, question: str) -> str:
        """Single-turn contextual answer for the chat widget."""
        prompt = f"{get_prompt('chat_system')}\n\n{system_context}\n\nUser: {question}\nAssistant:"
        return self._call_llm(prompt).strip()

    def chat_stream(self, system_context: str, question: str) -> Iterator[str]:
        """Token-streaming variant of chat()."""
        prompt = f"{get_prompt('chat_system')}\n\n{system_context}\n\nUser: {question}\nAssistant:"
        yield from self.backend.generate_stream(
            prompt, None, max_tokens=self.max_tokens, temperature=self.temperature
        )

    def chat_session_stream(
        self, session_key: str, system_context: str, question: str,
        history_text: Optional[str] = None,
    ) -> Iterator[str]:
        """KV-cached multi-turn chat: the conversation's context prefills once
        per session and follow-up turns append to the session cache
        (Engine.chat_start/chat_turn).  Falls back to stateless chat_stream
        for backends without session support (e.g. the mock).

        history_text: persisted transcript to seed a FRESH session with —
        after a server restart or LRU eviction the in-device KV is gone,
        and without this the SQLite chat memory would be cosmetic; ignored
        when the session's KV already holds the conversation."""
        engine = getattr(self.backend, "engine", None)
        if engine is None or not hasattr(engine, "chat_start"):
            yield from self.chat_stream(system_context, question)
            return
        # Each session pins a full max_cache_tokens KV buffer in device
        # memory: the map is a bounded LRU (oldest conversation's cache is
        # dropped; a returning user transparently re-prefills).  Guarded by
        # a lock — concurrent first chats from ThreadingHTTPServer threads
        # would otherwise double-build and leak a cache.
        with self._chat_lock:
            session = self._chat_sessions.get(session_key)
            if session is not None:
                self._chat_sessions.move_to_end(session_key)
            else:
                # Build INSIDE the lock: a check-then-act gap here lets two
                # ThreadingHTTPServer threads each run a full device prefill
                # for the same key, with one session's KV silently orphaned.
                # Holding the lock serializes only first-message prefills
                # (device calls serialize on the chip anyway); streaming
                # below runs unlocked.
                seed = f"{get_prompt('chat_system')}\n\n{system_context}"
                if history_text:
                    seed += f"\n\nConversation so far:\n{history_text}"
                session = engine.chat_start(seed)
                self._chat_sessions[session_key] = session
                while len(self._chat_sessions) > 4:
                    evicted_key, _ = self._chat_sessions.popitem(last=False)
                    self.logger.info(
                        f"Evicted idle chat session {evicted_key} "
                        "(KV cache returned)"
                    )
        try:
            yield from engine.chat_turn(
                session, question, max_tokens=self.max_tokens
            )
        except RuntimeError as exc:
            # Session budget exhausted: drop the cache and restart fresh.
            self.logger.warning(f"Chat session {session_key} reset: {exc}")
            self._chat_sessions.pop(session_key, None)
            yield from self.chat_stream(system_context, question)

    def rewrite_query(self, question: str, history: List[Any]) -> str:
        """History-aware standalone-question rewriting via this agent's LLM."""
        from vis_tpu_torch.chat_memory import rewrite_query_with_history

        return rewrite_query_with_history(question, history, llm=self._call_llm)


__all__ = ["ExplainerAgent"]
