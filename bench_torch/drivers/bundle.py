"""Driver ``bundle``: the explanation node's report bundle.

The entry is the program's ``ExplainerAgent.generate_report_bundle`` over
an ``EngineBackend`` of one engine (role ``explainer``) with its paged
scheduler attached: narration, counterfactual and, when the findings hold
a defect, decision support under its schema, decoded together in the
scheduler's slots.  Closed loop, one bundle at a time.  The findings (a
block holds one bundle of each of the traffic's defect counts, in a seeded
order) are built before the window with the program's
own consensus and gate code; every other bundle is greedy, the first
among them, and the check compares the greedy ones.
"""

from __future__ import annotations

import datetime
from typing import Any, Dict, List

from bench_torch.harness.check import cut_ids, min_budget, prompt_cut
from bench_torch.harness.engines import build_engine, release_engine
from bench_torch.harness.record import RecordingBackend
from bench_torch.harness.serve import balanced, byte_ids, pick_for_check, rng_for, schema_ok

SCHEMA = "decision_support"
STAMP = datetime.datetime(2026, 1, 1)


def findings(run, index: int, n_defects: int):
    """(inspector result, auditor result, consensus dict, verdict dict) of
    one bundle, from the seed."""
    from vis_tpu_torch.safety import analyze_consensus, evaluate_safety
    from vis_tpu_torch.schemas.models import (
        BoundingBox, DefectInfo, InspectionContext, VLMAnalysisResult,
    )

    t = run.traffic
    rng = rng_for(run.seed, "bundle", index)
    obj = rng.choice(t["objects"])

    def defect(k):
        x, y = rng.uniform(0, 80), rng.uniform(0, 80)
        return DefectInfo(
            defect_id=f"bench_{index}_{k}", type=rng.choice(t["defect_types"]),
            location=rng.choice(t["locations"]),
            bbox=BoundingBox(x=x, y=y, width=rng.uniform(1, 20), height=rng.uniform(1, 20)),
            safety_impact=rng.choice(t["severities"]),
            reasoning="visible damage at the stated location, confirmed under raking light",
            confidence=rng.choice(["high", "medium"]),
            recommended_action="repair or replace per the maintenance manual")

    defects = [defect(k) for k in range(n_defects)]
    condition = "damaged" if defects else "good"

    def result(reasoning):
        return VLMAnalysisResult(object_identified=obj, overall_condition=condition,
                                 defects=defects, overall_confidence="high",
                                 analysis_reasoning=reasoning, timestamp=STAMP)

    ins = result("The surface was examined region by region under even lighting.")
    aud = result("Independent pass over the same photo; findings as listed.")
    consensus = analyze_consensus(ins, aud)
    verdict = evaluate_safety(consensus, InspectionContext(image_id=f"bench-{index}",
                                                           criticality="high"))
    verdict_dict = verdict.model_dump()
    verdict_dict["timestamp"] = STAMP
    return ins, aud, consensus.model_dump(), verdict_dict


class Driver:
    def __init__(self, run):
        self.run = run

    def setup(self) -> None:
        from vis_tpu_torch.agents.explainer import ExplainerAgent
        from vis_tpu_torch.serving.engine import EngineBackend

        run = self.run
        self.engine = build_engine(run.model, "explainer", run.seed, run.device)
        self.engines = [self.engine]
        run.recorder.watch_engine(self.engine)
        backend = RecordingBackend(EngineBackend(self.engine), run.recorder)
        self.agent = ExplainerAgent(backend)
        self.sampled_temperature = self.agent.temperature
        counts = balanced(run.seed, run.traffic["defect_counts"], run.traffic["planned"], "defects")
        self.specs = [{"index": i, "defects": n, "greedy": i % run.traffic["greedy_every"] == 0,
                       "inputs": findings(run, i, n)} for i, n in enumerate(counts)]
        # The scheduler's one decode loop (the constrained paged loop, which
        # every row rides) and its prefill hand-off, once.
        backend.generate("warm-up", None, max_tokens=8, temperature=0.0)

    def requests(self):
        return iter(self.specs)

    def serve(self, spec) -> Dict[str, Any]:
        self.agent.temperature = 0.0 if spec["greedy"] else self.sampled_temperature
        start = len(self.run.recorder.requests)
        _, _, decision = self.agent.generate_report_bundle(*spec["inputs"])
        recs = self.run.recorder.requests[start:]
        failed = any(r["error"] for r in recs) or (
            spec["defects"] > 0 and not any(
                r["kwargs"].get("json_schema") == SCHEMA and schema_ok(r["text"], SCHEMA)
                for r in recs))
        return {"tokens": sum(len(r["ids"] or []) for r in recs), "failed": failed,
                "greedy": spec["greedy"], "spec": spec, "recs": recs}

    def _item(self, rec) -> Dict[str, Any]:
        kw = rec["kwargs"]
        schema = kw.get("json_schema") if kw.get("json_mode") else None
        max_tokens = int(kw["max_tokens"])
        if schema is not None:
            max_tokens = max(max_tokens, min_budget(schema))
        ids = byte_ids(rec["prompt"])
        bucket = prompt_cut(len(ids), max_tokens, self.run.serving, paged=True)
        served = {"ids": list(rec["ids"]), "served": True, "schema": schema,
                  "max_tokens": max_tokens,
                  "floor": int(kw["min_tokens"] if kw.get("min_tokens") is not None
                               else self.run.serving["CONSTRAINED_JSON_MIN_TOKENS"])}
        return {"seed": self.run.seed, "pieces": [{"ids": cut_ids(ids, bucket)}, served]}

    def check_items(self, done: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        picked = pick_for_check(done, self.run.seed, self.run.traffic["check_requests"])
        return [self._item(r) for d in picked for r in d["recs"] if r["ids"]]

    def release(self) -> None:
        release_engine(self.engine)
        self.engine = self.agent = None
