"""Boundaries of the PyTorch port: it never imports jax nor the JAX package
(vis_tpu), its kernel modules call no library attention or compiler, and
each kernel wrapper, handed CPU tensors, runs its plain version and
launches nothing."""

import ast
import json
from pathlib import Path

import pytest

from torch_port import run_port

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "vis_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
# Every file of the port, and the scripts that drive it with vis_tpu blocked.
STANDALONE_FILES = PORT_FILES + [REPO / "tools" / "profile_port_decode.py",
                                 REPO / "tools" / "compare_slices.py",
                                 REPO / "tests" / "torch_port_runner.py"]
KERNEL_MODULES = [REPO / "vis_tpu_torch" / "ops" / n
                  for n in ("quantized.py", "flash_attention.py", "int_dot.py")]
FORBIDDEN_CALLS = {"scaled_dot_product_attention", "compile", "multi_head_attention_forward",
                   "_scaled_dot_product_flash_attention", "_scaled_dot_product_efficient_attention"}
WRAPPERS = ("q4_matmul", "q4_matmul_stacked", "flash_attention", "q8_matmul",
            "fused_swiglu_mlp", "q4_matmul_folded", "q4_matmul_stacked_folded", "i4_matmul",
            "q4_fused_mlp_slab", "u8_sum", "i8_matmul", "q4_i8_matmul", "q4_i8s_matmul")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax(path):
    bad = [m for m in _imports(path) if m == "jax" or m.startswith("jax.")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", STANDALONE_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_the_jax_package(path):
    bad = [m for m in _imports(path) if m == "vis_tpu" or m.startswith("vis_tpu.")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", KERNEL_MODULES, ids=lambda p: p.name)
def test_kernel_modules_call_no_library_attention(path):
    tree = ast.parse(path.read_text())
    called = {node.func.attr for node in ast.walk(tree)
              if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)}
    assert not called & FORBIDDEN_CALLS, called & FORBIDDEN_CALLS


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    return run_port("boundaries", {}, tmp_path_factory.mktemp("torch_boundaries"))


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_wrapper_on_cpu_runs_its_plain_version(cpu_run, wrapper):
    assert json.loads(str(cpu_run["same"]))[wrapper]
    assert json.loads(str(cpu_run["launches"]))[wrapper] == 0


def test_cpu_run_never_loads_the_kernel_library(cpu_run):
    assert not bool(cpu_run["library_loaded"])


def test_install_cuda_raises_without_a_card(cpu_run):
    if bool(cpu_run["cuda_available"]):
        pytest.skip("this host has a CUDA device")
    assert "no CUDA device" in str(cpu_run["install_error"])
