"""Int4 quantization and kernels A/B of the PyTorch port against the JAX
package on the same inputs (port side in a subprocess, see torch_port.py).

The port's int4 matmul has the JAX package's dequantized-path semantics
(x and the dequantized weight rounded to bf16, f32 sums).  Against the JAX
dequant fallback the only difference is the order of accumulation:
max|err| <= 1e-4 * max|y|.  The TPU kernel (run here in interpret mode)
scales in f32 after the dot instead of rounding each dequantized weight to
bf16, so against it the bound adds that rounding: 2^-8 * max_o sum_i
|x_i * w_oi|.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from vis_tpu.ops.quantized import (
    QuantizedWeight4,
    QuantizedWeight4Pick,
    embed_rows4,
    quantize_weight4,
    quantized_matmul4,
    quantized_matmul4_stacked,
    unpack_int4,
)
from torch_port import run_port

ROWS = (1, 8, 130)
WEIGHTS = ("single", "stacked0", "stacked2")


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    rng = np.random.default_rng(11)
    inp, jax_out = {}, {}
    square = rng.standard_normal((512, 512)).astype(np.float32)
    padded = rng.standard_normal((200, 128)).astype(np.float32)
    for name, w, pad in (("square", square, 1), ("padded", padded, 256)):
        qw = quantize_weight4(jnp.asarray(w), pad_out_multiple=pad)
        inp[f"{name}/w"], inp[f"{name}/pad"] = w, np.array(pad)
        inp[f"{name}/jax_q"] = np.asarray(qw.q)
        inp[f"{name}/jax_scale"] = np.asarray(qw.scale)
    qw = QuantizedWeight4(jnp.asarray(inp["square/jax_q"]), jnp.asarray(inp["square/jax_scale"]))
    jax_out["unpack/f32"] = _f32(unpack_int4(qw.q.astype(jnp.int32), qw.scale, jnp.float32))
    jax_out["unpack/bf16"] = _f32(unpack_int4(qw.q.astype(jnp.int32), qw.scale))
    ids = rng.integers(0, 512, (2, 5)).astype(np.int64)
    inp["embed/ids"] = ids
    jax_out["embed"] = _f32(embed_rows4(qw, jnp.asarray(ids)))

    stack = [quantize_weight4(jnp.asarray(rng.standard_normal((512, 512)).astype(np.float32)))
             for _ in range(3)]
    stack_q = jnp.stack([s.q for s in stack])
    stack_s = jnp.stack([s.scale for s in stack])
    inp["stack/q"], inp["stack/scale"] = np.asarray(stack_q), np.asarray(stack_s)
    inp["rows"] = np.array(ROWS)
    dequant = {"single": _f32(qw.dequantize(jnp.float32))}
    for rows in ROWS:
        x = rng.standard_normal((rows, 512)).astype(np.float32)
        inp[f"x{rows}"] = x
        xj = jnp.asarray(x)
        weights = {"single": qw}
        for idx in (0, 2):
            weights[f"stacked{idx}"] = QuantizedWeight4Pick(stack_q, stack_s, jnp.int32(idx))
            dequant[f"stacked{idx}"] = _f32(stack[idx].dequantize(jnp.float32))
        for name, w in weights.items():
            fn = quantized_matmul4 if name == "single" else quantized_matmul4_stacked
            jax_out[f"{name}/{rows}/fallback"] = np.asarray(fn(xj, w))
            jax_out[f"{name}/{rows}/kernel"] = np.asarray(fn(xj, w, interpret=True))
            xb = _f32(xj.astype(jnp.bfloat16))
            jax_out[f"{name}/{rows}/bound"] = np.abs(xb) @ np.abs(dequant[name]).T
    x = rng.standard_normal((1, 128)).astype(np.float32)
    inp["padded/x"] = x
    pq, ps = jnp.asarray(inp["padded/jax_q"]), jnp.asarray(inp["padded/jax_scale"])
    jax_out["zero_rows"] = np.asarray(quantized_matmul4_stacked(
        jnp.asarray(x), QuantizedWeight4Pick(pq[None], ps[None], jnp.int32(0)), interpret=True))
    port = run_port("quantized", inp, tmp_path_factory.mktemp("torch_quantized"))
    return inp, jax_out, port


@pytest.mark.parametrize("name", ["square", "padded"])
def test_quantize_weight4_bytes_match(sides, name):
    inp, _, port = sides
    np.testing.assert_array_equal(port[f"{name}/q"], inp[f"{name}/jax_q"])
    np.testing.assert_array_max_ulp(port[f"{name}/scale"], inp[f"{name}/jax_scale"], maxulp=1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_unpack_int4_matches(sides, dtype):
    _, jax_out, port = sides
    np.testing.assert_array_equal(port[f"unpack/{dtype}"], jax_out[f"unpack/{dtype}"])


def test_embed_rows4_matches(sides):
    _, jax_out, port = sides
    np.testing.assert_array_equal(port["embed"], jax_out["embed"])


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("weight", WEIGHTS)
def test_matmul_matches_jax_dequant_path(sides, weight, rows):
    _, jax_out, port = sides
    want = jax_out[f"{weight}/{rows}/fallback"]
    err = np.abs(port[f"{weight}/{rows}"] - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err


@pytest.mark.parametrize("rows", (1, 8))
@pytest.mark.parametrize("weight", WEIGHTS)
def test_matmul_matches_jax_kernel_within_bf16_weight_rounding(sides, weight, rows):
    _, jax_out, port = sides
    want = jax_out[f"{weight}/{rows}/kernel"]
    err = np.abs(port[f"{weight}/{rows}"] - want).max()
    bound = 2.0 ** -8 * jax_out[f"{weight}/{rows}/bound"].max() + 1e-4 * np.abs(want).max()
    assert err <= bound, (err, bound)


def test_zero_padded_rows_stay_zero(sides):
    _, jax_out, port = sides
    assert np.abs(port["zero_rows"][:, 200:]).max() == 0.0
    assert np.abs(jax_out["zero_rows"][:, 200:]).max() == 0.0
    want = jax_out["zero_rows"]
    assert np.abs(port["zero_rows"] - want).max() <= 1e-4 * np.abs(want).max()
