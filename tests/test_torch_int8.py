"""Int8 weight-only quantization and kernel D of the PyTorch port against
the JAX package on the same inputs (port side in a subprocess, see
torch_port.py), and the Llama-3 RoPE frequency scaling.

Kernel D's semantics are the TPU kernel's: x rounded to bf16, products
with the exact int8 value summed in f32, the row scale applied after the
sum.  Against the JAX kernel (run here in interpret mode, forced as
tests/test_quantized.py does) the only difference is the order of
accumulation: max|err| <= 1e-4 * max|y|.  At 130 rows both sides leave
the kernel for the dequantized path.  The JAX CPU fallback rounds each
dequantized weight q*scale to bf16 before the dot, so against it the bound
is that rounding: 2^-8 * max_o sum_i |x_i * w_oi| (plus the 1e-4 term).
Quantized bytes, scales, padded rows and the int8 embedding gather are
compared exactly; RoPE frequencies to 1e-6 relative (the same f32
operations in the same order on both sides).
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vis_tpu.models.common.layers import embed, rope_frequencies
from vis_tpu.models.llama.config import _LLAMA3_SCALING
from vis_tpu.ops.quantized import quantize_weight, quantized_matmul
from torch_port import run_port

ROWS = (1, 3, 8, 130)
ROPE = [(128, 500000.0, 1), (16, 500000.0, 1), (128, 500000.0, 0), (64, 10000.0, 1)]


def _kernel(x, qw):
    """quantized_matmul through the Pallas kernel, in interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        orig = jax.default_backend
        try:
            jax.default_backend = lambda: "tpu"
            return np.asarray(quantized_matmul(x, qw))
        finally:
            jax.default_backend = orig


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    rng = np.random.default_rng(21)
    inp, ref = {}, {}
    square = rng.standard_normal((512, 256)).astype(np.float32)
    padded = rng.standard_normal((200, 128)).astype(np.float32)
    for name, w, pad in (("square", square, 1), ("padded", padded, 512)):
        qw = quantize_weight(jnp.asarray(w), pad_out_multiple=pad)
        inp[f"{name}/w"], inp[f"{name}/pad"] = w, np.array(pad)
        inp[f"{name}/jax_q"], inp[f"{name}/jax_scale"] = np.asarray(qw.q), np.asarray(qw.scale)
    qw = quantize_weight(jnp.asarray(square))
    ids = rng.integers(0, 512, (2, 5)).astype(np.int64)
    inp["embed/ids"] = ids
    ref["embed"] = np.asarray(embed(jnp.asarray(ids), qw).astype(jnp.float32))
    inp["rows"] = np.array(ROWS)
    dequant = np.asarray(qw.dequantize(jnp.float32))
    for rows in ROWS:
        x = rng.standard_normal((rows, 256)).astype(np.float32)
        inp[f"x{rows}"] = x
        xj = jnp.asarray(x)
        ref[f"{rows}/fallback"] = np.asarray(quantized_matmul(xj, qw))
        ref[f"{rows}/kernel"] = _kernel(xj, qw)
        xb = np.asarray(xj.astype(jnp.bfloat16).astype(jnp.float32))
        ref[f"{rows}/bound"] = np.abs(xb) @ np.abs(dequant).T
    x = rng.standard_normal((1, 128)).astype(np.float32)
    inp["padded/x"] = x
    ref["zero_rows"] = _kernel(jnp.asarray(x), quantize_weight(jnp.asarray(padded), 512))
    inp["rope"] = np.array(ROPE)
    inp["rope_scaling"] = np.array(json.dumps(_LLAMA3_SCALING))
    for i, (head_dim, theta, scaled) in enumerate(ROPE):
        scaling = dict(_LLAMA3_SCALING) if scaled else None
        ref[f"rope{i}"] = np.asarray(rope_frequencies(head_dim, theta, scaling))
    port = run_port("int8", inp, tmp_path_factory.mktemp("torch_int8"))
    return inp, ref, port


@pytest.mark.parametrize("name", ["square", "padded"])
def test_quantize_weight_bytes_match(sides, name):
    inp, _, port = sides
    np.testing.assert_array_equal(port[f"{name}/q"], inp[f"{name}/jax_q"])
    np.testing.assert_array_equal(port[f"{name}/scale"], inp[f"{name}/jax_scale"])
    if name == "padded":  # 200 rows padded to 512 with zero bytes and scales
        assert port["padded/q"].shape == (512, 128)
        assert not port["padded/q"][200:].any() and not port["padded/scale"][200:].any()


def test_embed_rows8_bit_equal(sides):
    _, ref, port = sides
    np.testing.assert_array_equal(port["embed"], ref["embed"])


@pytest.mark.parametrize("rows", ROWS)
def test_matmul_matches_jax_kernel(sides, rows):
    _, ref, port = sides
    want = ref[f"{rows}/kernel"]
    err = np.abs(port[f"matmul/{rows}"] - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err


@pytest.mark.parametrize("rows", ROWS)
def test_matmul_matches_jax_fallback_within_bf16_weight_rounding(sides, rows):
    _, ref, port = sides
    want = ref[f"{rows}/fallback"]
    err = np.abs(port[f"matmul/{rows}"] - want).max()
    bound = 2.0 ** -8 * ref[f"{rows}/bound"].max() + 1e-4 * np.abs(want).max()
    assert err <= bound, (err, bound)


def test_zero_padded_rows_exactly_zero(sides):
    _, ref, port = sides
    assert port["zero_rows"].shape == (1, 512)
    assert np.abs(port["zero_rows"][:, 200:]).max() == 0.0
    assert np.abs(ref["zero_rows"][:, 200:]).max() == 0.0
    want = ref["zero_rows"]
    assert np.abs(port["zero_rows"] - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("index", range(len(ROPE)))
def test_rope_frequencies_llama3_scaling(sides, index):
    _, ref, port = sides
    np.testing.assert_allclose(port[f"rope{index}"], ref[f"rope{index}"], rtol=1e-6, atol=0)
