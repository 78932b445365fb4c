"""Kernel C's plain version (the port's flash_attention on CPU tensors)
against the JAX package's Pallas flash kernel in interpret mode, on the
same f32 inputs: atol 2e-5, rtol 1e-4, as tests/test_flash_attention.py
holds the JAX kernel to its reference.  Only query rows inside each
batch row's valid length are compared when lengths pad."""

import json

import numpy as np
import pytest

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vis_tpu.ops.flash_attention import flash_attention
from torch_port import run_port

B, S, H = 2, 256, 2
CASES = {
    f"d{d}-{'causal' if causal else 'full'}-{lens}": (d, causal, lens)
    for d in (64, 80)
    for causal in (False, True)
    for lens in ("all", "200_131", "0_131")
}


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    rng = np.random.default_rng(5)
    inp, jax_out = {"cases": np.array(json.dumps(list(CASES)))}, {}
    for name, (d, causal, lens) in CASES.items():
        q, k, v = (rng.standard_normal((B, S, H, d)).astype(np.float32) for _ in range(3))
        lengths = None if lens == "all" else np.array(
            [int(n) for n in lens.split("_")], np.int32)
        inp.update({f"{name}/q": q, f"{name}/k": k, f"{name}/v": v,
                    f"{name}/causal": np.array(causal)})
        if lengths is not None:
            inp[f"{name}/lengths"] = lengths
        with pltpu.force_tpu_interpret_mode():
            out = flash_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                None if lengths is None else jnp.asarray(lengths), causal=causal,
            )
        jax_out[name] = np.asarray(out)
    port = run_port("flash", inp, tmp_path_factory.mktemp("torch_flash"))
    return inp, jax_out, port


@pytest.mark.parametrize("name", list(CASES))
def test_flash_plain_matches_jax_kernel(sides, name):
    inp, jax_out, port = sides
    lengths = inp.get(f"{name}/lengths", np.full((B,), S))
    for row, n in enumerate(lengths.tolist()):
        np.testing.assert_allclose(
            port[name][row, :n], jax_out[name][row, :n], atol=2e-5, rtol=1e-4
        )


@pytest.mark.parametrize("name", [n for n in CASES if n.endswith("-0_131")])
def test_row_without_valid_keys_is_zero(sides, name):
    _, jax_out, port = sides
    assert np.abs(port[name][0]).max() == 0.0
    np.testing.assert_array_equal(jax_out[name][0], 0.0)
