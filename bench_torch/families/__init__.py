"""Model families: everything of the benchmark that depends on a model's
architecture, one file a family, found by the ``model_type`` of the
configuration file's ``model`` section: ``families/<model_type>.py``.

A family file gives these plain functions, each taking the ``model``
section first:

- ``plan_weights(plan, model)``: adds the family's leaves to the shared
  ``harness.weights._Plan`` (their order fixes the seeded bytes), and
  ``finish_weights(tree, model) -> tree``;
- ``program_config(model)``: the port's config object for its ``Engine``;
- ``sequence(model, item, weights, device)``: a check item's inputs, with
  ``served``, the list of (served piece, its first row), and
  ``logits(model, weights, seq, rows, prec)``: the plain float32
  reference's logits [len(rows), vocab] at the sequence rows ``rows``
  under a ``reference.primitives.Precision``;
- ``prefill_flops(model, n)``, ``decode_flops(model, tokens,
  context_sum)``, ``decode_bytes(model, passes, context_sum)`` and
  ``input_flops(model, record)`` (what a request's inputs cost before its
  prompt, such as a vision tower): the work arithmetic of
  ``harness/work.py``.

A file whose name starts with ``_`` is no family but code that families
share: ``_dense_gqa.py``, the dense GQA text decoder.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Any, Dict

from bench_torch.harness.spec import BENCH_DIR, load_module

FAMILY_DIR = BENCH_DIR / "families"


def family_path(model: Dict[str, Any]) -> Path:
    model_type = model.get("model_type")
    if not isinstance(model_type, str) or not model_type or "/" in model_type \
            or model_type[0] in "_.":
        raise SystemExit(f"the configuration's model section has no usable model_type: "
                         f"{model_type!r}")
    return FAMILY_DIR / f"{model_type}.py"


def family_of(model: Dict[str, Any]):
    """The family module of a configuration file's ``model`` section, loaded
    once; a ``model_type`` with no file stops the run, naming the missing
    path."""
    path = family_path(model)
    name = f"bench_family_{path.stem}"
    module = sys.modules.get(name)
    if module is None or Path(module.__file__) != path:
        if not path.is_file():
            raise SystemExit(f"no model family file {path} for model_type "
                             f"{model['model_type']!r}: add one (see "
                             f"bench_torch/families/__init__.py)")
        module = load_module(path, name)
    return module


__all__ = ["FAMILY_DIR", "family_of", "family_path"]
