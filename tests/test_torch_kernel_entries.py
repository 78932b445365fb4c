"""The port's kernel library binds each C entry point by name with a fixed
argument list (``vis_tpu_torch/ops/_kernels.py``, ``_SIGNATURES``).  A name
that no source defines, or defines twice, fails only when the library is
linked or loaded on a machine with a card; an argument count that differs
passes ctypes silently.  These tests read the files as text (no torch, no
build) and hold the table and the sources ``vis_tpu_torch/csrc/*.cu`` to
each other: every signature has exactly one ``extern "C" int <name>(``
with as many parameters, and every such entry has a signature."""

import ast
import re
from pathlib import Path

import pytest

PORT = Path(__file__).resolve().parents[1] / "vis_tpu_torch"
ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _signatures() -> dict:
    """``_SIGNATURES`` from _kernels.py's source: name -> argument count."""
    tree = ast.parse((PORT / "ops" / "_kernels.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "_SIGNATURES"):
            return {key.value: len(value.elts)
                    for key, value in zip(node.value.keys, node.value.values)}
    raise AssertionError("_kernels.py defines no _SIGNATURES")


def _entries() -> list:
    """Every ``extern "C" int name(...)`` in the sources: (file, name, arity)."""
    found = []
    for src in sorted((PORT / "csrc").glob("*.cu")):
        for name, params in ENTRY.findall(src.read_text()):
            found.append((src.name, name, len([p for p in params.split(",") if p.strip()])))
    return found


SIGNATURES = _signatures()


@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_signature_has_one_entry_with_its_arity(name):
    matches = [(src, arity) for src, entry, arity in _entries() if entry == name]
    assert len(matches) == 1, (name, matches)
    assert matches[0][1] == SIGNATURES[name], (name, matches[0], SIGNATURES[name])


def test_every_entry_has_a_signature():
    unbound = [(src, name) for src, name, _ in _entries() if name not in SIGNATURES]
    assert not unbound, unbound
