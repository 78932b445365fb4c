"""The port's kernel library binds each C entry point by name with a fixed
argument list (``vis_tpu_torch/ops/_kernels.py``, ``_SIGNATURES``).  A name
that no source defines, or defines twice, fails only when the library is
linked or loaded on a machine with a card; an argument count that differs
passes ctypes silently.  These tests read the files as text (no torch, no
build) and hold the table and the sources ``vis_tpu_torch/csrc/*.cu`` to
each other: every signature has exactly one ``extern "C" int <name>(``
with as many parameters, and every such entry has a signature.  They also
hold ``chip_smoke.py``'s ``KERNELS`` table, which names each kernel's source
in the lines the card run prints, to the files: every named source exists
and defines the C entry that the named wrapper calls, so a kernel that moves
to another file cannot leave the table pointing at the old one."""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "vis_tpu_torch"
WRAPPER_MODULES = [PORT / "ops" / n for n in ("quantized.py", "int_dot.py", "flash_attention.py")]
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


def _kernel_table() -> dict:
    """``KERNELS`` from chip_smoke.py's source: key -> (wrapper, source, replaces)."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "KERNELS"):
            return {key.value: tuple(elt.value for elt in value.elts)
                    for key, value in zip(node.value.keys, node.value.values)}
    raise AssertionError("chip_smoke.py defines no KERNELS")


def _entries_called(wrapper: str) -> set:
    """The C entries (``vt_*``) that the wrapper function names, as a string
    or as an attribute of the library, in the port's kernel modules."""
    called = set()
    for path in WRAPPER_MODULES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.FunctionDef) and node.name == wrapper:
                for inner in ast.walk(node):
                    if isinstance(inner, ast.Constant) and isinstance(inner.value, str):
                        called.update(re.findall(r"\bvt_\w+", inner.value))
                    elif isinstance(inner, ast.Attribute) and inner.attr.startswith("vt_"):
                        called.add(inner.attr)
    return called


KERNEL_TABLE = _kernel_table()


@pytest.mark.parametrize("key", sorted(KERNEL_TABLE))
def test_chip_smoke_kernel_source_defines_the_wrappers_entry(key):
    wrapper, source, _ = KERNEL_TABLE[key]
    path = REPO / source
    assert path.is_file(), (key, source)
    called = _entries_called(wrapper)
    assert called, (key, wrapper, "names no vt_ entry")
    defined = {name for name, _ in ENTRY.findall(path.read_text())}
    assert called <= defined, (key, source, sorted(called - defined))
