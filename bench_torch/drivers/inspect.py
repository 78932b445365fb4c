"""Driver ``inspect``: the inspector's request, one photo at a time.

The entry is the program's ``InspectorAgent.analyze`` over an
``EngineBackend`` of one engine (role ``inspector``): the tower, the
M-RoPE prefill and the schema-constrained lookahead decode.  Closed loop,
one client.  Photos, contexts and greedy-or-sampled come from the traffic
file and the seed (``plan``); every other request is greedy, starting with
the first, and the check compares the greedy ones.
"""

from __future__ import annotations

from typing import Any, Dict, List

from bench_torch.harness.check import min_budget
from bench_torch.harness.engines import build_engine, release_engine
from bench_torch.harness.photos import write_photo
from bench_torch.harness.record import RecordingBackend
from bench_torch.harness.serve import balanced, byte_ids, pick_for_check, rng_for, schema_ok

SCHEMA = "inspection"


def plan_photos(run, n: int) -> List[Dict[str, Any]]:
    """``n`` photo requests: sizes in seeded blocks of every size (so any
    window holds the same mix), each landscape or portrait, the context
    drawn per request, every other request greedy."""
    t = run.traffic
    order = balanced(run.seed, [tuple(s) for s in t["sizes"]], n, "sizes")
    turns = balanced(run.seed, [False, True], n, "orientation")
    rng = rng_for(run.seed, "context")
    out = []
    for i, ((h, w), portrait) in enumerate(zip(order, turns)):
        if portrait:
            h, w = w, h
        out.append({
            "index": i, "height": h, "width": w, "seed": run.seed,
            "greedy": i % t["greedy_every"] == 0,
            "criticality": rng.choice(t["criticality"]),
            "domain": rng.choice(t["domains"]),
            "notes": rng.choice(t["notes"]),
        })
    return out


def warm_up(backend, run, specs) -> None:
    """Every kernel and table of the path, once: the largest photo's tower
    and prefill, and a schema answer of the schema's least budget through
    the lookahead decode."""
    largest = max(specs, key=lambda s: s["height"] * s["width"])
    photo = write_photo(dict(largest, index=10 ** 6), run.workdir)
    backend.generate("warm-up", photo, max_tokens=min_budget(SCHEMA), temperature=0.0,
                     json_mode=True, json_schema=SCHEMA, min_tokens=0)
    photo.unlink()


def context_of(spec: Dict[str, Any]):
    from vis_tpu_torch.schemas.models import InspectionContext

    return InspectionContext(image_id=f"bench-{spec['index']}", criticality=spec["criticality"],
                             domain=spec["domain"], user_notes=spec["notes"])


def vlm_item(rec: Dict[str, Any], spec: Dict[str, Any], seed: int, served) -> Dict[str, Any]:
    kw = rec["kwargs"]
    return {
        "seed": seed,
        "label": f"{rec.get('role', 'inspector')} photo {spec['index']} "
                 f"{spec['height']}x{spec['width']}",
        "photo": {k: spec[k] for k in ("seed", "index", "height", "width")},
        "pieces": [
            {"ids": byte_ids(rec["prompt"])},
            {"ids": list(served), "served": True, "schema": SCHEMA,
             "max_tokens": max(int(kw["max_tokens"]), min_budget(SCHEMA)),
             "floor": int(kw["min_tokens"] or 0)},
        ],
    }


class Driver:
    def __init__(self, run):
        self.run = run
        self.paths = []

    def setup(self) -> None:
        from vis_tpu_torch.agents.inspector import VLMInspectorAgent
        from vis_tpu_torch.serving.engine import EngineBackend

        run = self.run
        self.engine = build_engine(run.model, "inspector", run.seed, run.device)
        self.engines = [self.engine]
        run.recorder.watch_engine(self.engine)
        backend = RecordingBackend(EngineBackend(self.engine), run.recorder)
        self.agent = VLMInspectorAgent(backend)
        self.sampled_temperature = self.agent.temperature
        self.specs = plan_photos(run, run.traffic["planned"])
        self.paths = [write_photo(s, run.workdir) for s in self.specs]
        warm_up(backend, run, self.specs)

    def requests(self):
        return iter(zip(self.specs, self.paths))

    def serve(self, item) -> Dict[str, Any]:
        spec, path = item
        self.agent.temperature = 0.0 if spec["greedy"] else self.sampled_temperature
        result = self.agent.analyze(path, context_of(spec))
        rec = self.run.recorder.requests[-1]
        failed = bool(result.analysis_failed) or not schema_ok(rec["text"], SCHEMA)
        return {"tokens": len(rec["ids"] or []), "failed": failed, "greedy": spec["greedy"],
                "spec": spec, "rec": rec}

    def check_items(self, done: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        picked = pick_for_check(done, self.run.seed, self.run.traffic["check_requests"])
        return [vlm_item(d["rec"], d["spec"], self.run.seed, d["rec"]["ids"]) for d in picked]

    def release(self) -> None:
        release_engine(self.engine)
        self.engine = self.agent = None
        for path in self.paths:
            path.unlink(missing_ok=True)
