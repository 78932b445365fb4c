"""The system under test, built from a configuration file.

The program's ``Engine`` (``vis_tpu_torch.serving.engine``), given the
benchmark's seeded weights in the program's serving layout, the
configuration's sizes, the byte-level tokenizer and the serving settings
that the environment (the configuration's ``serving`` section) gives the
program's config.  The port is imported here, after ``run.py`` has set
that environment.
"""

from __future__ import annotations

from typing import Any, Dict

from bench_torch.families import family_of
from bench_torch.harness.weights import make_weights


def _program_leaves(tree):
    from vis_tpu_torch.ops.quantized import QuantizedWeight, QuantizedWeight4

    if isinstance(tree, dict):
        if "q4" in tree:
            return QuantizedWeight4(q=tree["q4"], scale=tree["s"])
        if "q8" in tree:
            return QuantizedWeight(q=tree["q8"], scale=tree["s"])
        return {k: _program_leaves(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_program_leaves(v) for v in tree]
    return tree


def build_engine(model: Dict[str, Any], role: str, seed: int, device):
    """An ``Engine`` for ``role`` with weights from ``seed``; a scheduler is
    attached where the serving settings batch the role."""
    from vis_tpu_torch.serving.engine import Engine, ServingSettings
    from vis_tpu_torch.serving.tokenizer import ByteTokenizer
    from vis_tpu_torch.utils.config import config as app_config

    params = _program_leaves(make_weights(model, seed, device))
    engine = Engine(f"bench-{role}", family_of(model).program_config(model), params,
                    ByteTokenizer(vocab_size=model["vocab_size"]), device,
                    ServingSettings.from_app_config())
    roles = {r.strip() for r in app_config.batching_roles.split(",") if r.strip()}
    if app_config.continuous_batching and ("all" in roles or role in roles):
        engine.attach_scheduler()
    return engine


def release_engine(engine) -> None:
    if getattr(engine, "scheduler", None) is not None:
        engine.detach_scheduler()
    engine.params = None


__all__ = ["build_engine", "release_engine"]
