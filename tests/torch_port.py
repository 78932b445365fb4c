"""Shared harness for the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX side runs in the pytest process; ``run_port`` writes its inputs to
an .npz, runs tests/torch_port_runner.py in a subprocess (torch and jax
must not share a process here) and returns the port's outputs.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

RUNNER = Path(__file__).with_name("torch_port_runner.py")


def run_port(case: str, inputs: dict, tmp_dir: Path, timeout: int = 600) -> dict:
    in_path, out_path = tmp_dir / f"{case}_in.npz", tmp_dir / f"{case}_out.npz"
    np.savez(in_path, **inputs)
    proc = subprocess.run(
        [sys.executable, str(RUNNER), case, str(in_path), str(out_path)],
        capture_output=True, text=True, timeout=timeout,
    )
    if proc.returncode != 0:
        pytest.fail(f"port runner '{case}' failed:\n{proc.stderr[-4000:]}")
    with np.load(out_path, allow_pickle=False) as out:
        return {k: out[k] for k in out.files}


def flatten_params(tree, prefix: str, out: dict) -> dict:
    """A JAX parameter tree as "/"-joined key paths -> numpy, the form the
    port's ``params_from_numpy`` takes back: list items by index, an int4
    or int8 quantized weight as ".../q" and ".../scale"."""
    from vis_tpu.ops.quantized import QuantizedWeight, QuantizedWeight4

    if isinstance(tree, dict):
        for k, v in tree.items():
            flatten_params(v, f"{prefix}/{k}", out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            flatten_params(v, f"{prefix}/{i}", out)
    elif isinstance(tree, (QuantizedWeight, QuantizedWeight4)):
        out[f"{prefix}/q"], out[f"{prefix}/scale"] = np.asarray(tree.q), np.asarray(tree.scale)
    else:
        out[prefix] = np.asarray(tree)
    return out
