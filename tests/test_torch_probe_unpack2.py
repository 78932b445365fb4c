"""The int8 probe's kernels in the PyTorch port against the JAX probe's
Pallas kernels (``tools/probe_unpack2.py``), run in this process in
interpret mode (``pltpu.force_tpu_interpret_mode()``) on the same inputs;
the port side runs on the CPU in a subprocess (see torch_port.py), where
every wrapper takes its plain version.  Shapes are small: hidden 256, inter
512 (gate_up [1024, 256], down [256, 512]), rows 1 and 3, output dims
multiples of 128 as the probe's block picker needs.

Tolerances:

- L (``_stream_kernel``) and M (``_i8dot_kernel``) are integer sums, the
  second times one scale: bit-exact.  One L case (a [4096, 2304] u8 of
  255s, 8 grid steps) sums past 2^31, so both sides wrap.
- O (``_q4i8_kernel``) and P (``_q4i8s_kernel``): the integer sums, read
  through unit scales ([1, 0] and [0, 1]; exact below 2^24), are equal.
  The output f32(y_lo) s_lo + f32(y_hi) s_hi: XLA fuses one product and
  the add into an FMA, the port rounds the product first, so max|err| <=
  2^-22 * max(|f32(y_lo) s_lo| + |f32(y_hi) s_hi|).
- N (``_mixdot_kernel``) runs on the port's kernel D, whose plain version
  sums the same f32 products in another order: max|err| <= 1e-4 * max|y|.
- ``quant_act``: codes and scales bit-exact (bf16 in, bf16 scale).
- One layer of each variant's body (F, G, H, I): the two frameworks'
  SwiGLU can round an act value to the next bf16, and a code may move by
  one: max|err| <= 2^-6 * max|h|.  The JAX bodies are copies of the
  probe's ``stack_f/g/h/i`` layer bodies (nested in its ``main``).
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from torch_port import run_port

REPO = Path(__file__).resolve().parents[1]
HIDDEN, INTER = 256, 512
ROWS = (1, 3)
WEIGHTS = ("gu", "dn")
L_CASES = ("gate_up", "down", "wrap")


def _probe2():
    spec = importlib.util.spec_from_file_location("tools_probe_unpack2",
                                                  REPO / "tools" / "probe_unpack2.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _quantized_body(pu2, matmul, h, gq, gs, dq, ds):
    """The probe's F, H and I layer body (probe_unpack2.py:303-311,
    355-363, 381-389), ``matmul`` the probe function that calls its kernel."""
    h8, hs = pu2.quant_act(h)
    gu = matmul(h8, gq, gs) * hs
    g, u = jnp.split(gu, 2, axis=-1)
    act = (jax.nn.silu(g) * u).astype(jnp.bfloat16)
    a8, as_ = pu2.quant_act(act)
    d = matmul(a8, dq, ds) * as_
    return (h + d).astype(jnp.bfloat16)


def _mixed_body(pu2, h, gq, gs, dq, ds):
    """The probe's G layer body (probe_unpack2.py:329-335)."""
    gu = pu2.mix_dot(h, gq, gs)
    g, u = jnp.split(gu, 2, axis=-1)
    act = (jax.nn.silu(g) * u).astype(jnp.bfloat16)
    d = pu2.mix_dot(act, dq, ds)
    return (h + d).astype(jnp.bfloat16)


def _bodies(pu2, h, w8, w4):
    """Each variant's layer on h, with w8 / w4 (gq, gs, dq, ds) in the
    probe's layouts, in interpret mode."""
    h = jnp.asarray(h).astype(jnp.bfloat16)
    w8, w4 = [jnp.asarray(a) for a in w8], [jnp.asarray(a) for a in w4]
    with pltpu.force_tpu_interpret_mode():
        return {"F": np.asarray(_quantized_body(pu2, pu2.i8_dot, h, *w8).astype(jnp.float32)),
                "G": np.asarray(_mixed_body(pu2, h, *w8).astype(jnp.float32)),
                "H": np.asarray(_quantized_body(pu2, pu2.q4_i8dot, h, *w4).astype(jnp.float32)),
                "I": np.asarray(_quantized_body(pu2, pu2.q4_i8s_dot, h, *w4).astype(jnp.float32))}


def _bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    pu2 = _probe2()
    rng = np.random.default_rng(52)
    dims = {"gu": (2 * INTER, HIDDEN), "dn": (HIDDEN, INTER)}
    inp = {"rows": np.array(ROWS), "l_cases": np.array(json.dumps(L_CASES)),
           "l/gate_up": rng.integers(0, 256, (2 * INTER, HIDDEN // 2), dtype=np.uint8),
           "l/down": rng.integers(0, 256, (HIDDEN, INTER // 2), dtype=np.uint8),
           "l/wrap": np.full((4096, 2304), 255, np.uint8)}
    for w, (out, inn) in dims.items():
        inp[f"m/{w}"] = rng.integers(-127, 128, (out, inn)).astype(np.int8)
        inp[f"m/{w}s"] = (1e-4 * (1 + rng.random((1, out)))).astype(np.float32)
        inp[f"q4/{w}"] = rng.integers(0, 256, (out, inn // 2), dtype=np.uint8)
        inp[f"q4/{w}s"] = (0.01 + 0.01 * rng.random((2, out))).astype(np.float32)
        for rows in ROWS:
            inp[f"x8/{w}/{rows}"] = rng.integers(-127, 128, (rows, inn)).astype(np.int8)
            inp[f"xb/{w}/{rows}"] = _bf16(rng.standard_normal((rows, inn)))
    act = rng.standard_normal((4, HIDDEN)) * np.array([[1.0], [1e-3], [30.0], [0.0]])
    inp["act"] = _bf16(act)
    # Layer-body weights at scales that make d of the order of h.
    inp["body/x"] = _bf16(rng.standard_normal((3, HIDDEN)))
    inp["body/gu8"] = rng.integers(-127, 128, (2 * INTER, HIDDEN)).astype(np.int8)
    inp["body/gs8"] = (1e-3 * (1 + rng.random((1, 2 * INTER)))).astype(np.float32)
    inp["body/dn8"] = rng.integers(-127, 128, (HIDDEN, INTER)).astype(np.int8)
    inp["body/ds8"] = (1e-3 * (1 + rng.random((1, HIDDEN)))).astype(np.float32)
    inp["body/gu4"] = rng.integers(0, 256, (2 * INTER, HIDDEN // 2), dtype=np.uint8)
    inp["body/gs4"] = (0.02 * (1 + rng.random((2, 2 * INTER)))).astype(np.float32)
    inp["body/dn4"] = rng.integers(0, 256, (HIDDEN, INTER // 2), dtype=np.uint8)
    inp["body/ds4"] = (0.02 * (1 + rng.random((2, HIDDEN)))).astype(np.float32)

    ref = {}
    kernels = {"O": pu2.q4_i8dot, "P": pu2.q4_i8s_dot}
    with pltpu.force_tpu_interpret_mode():
        for name in L_CASES:
            ref[f"L/{name}"] = np.asarray(pu2.stream_pass(jnp.asarray(inp[f"l/{name}"])))
        for w in WEIGHTS:
            q8, s8 = jnp.asarray(inp[f"m/{w}"]), jnp.asarray(inp[f"m/{w}s"])
            q4, s4 = jnp.asarray(inp[f"q4/{w}"]), jnp.asarray(inp[f"q4/{w}s"])
            for rows in ROWS:
                x8 = jnp.asarray(inp[f"x8/{w}/{rows}"])
                ref[f"M/{w}/{rows}"] = np.asarray(pu2.i8_dot(x8, q8, s8))
                ref[f"N/{w}/{rows}"] = np.asarray(pu2.mix_dot(
                    jnp.asarray(inp[f"xb/{w}/{rows}"]), q8, s8))
                for key, fn in kernels.items():
                    ref[f"{key}/{w}/{rows}"] = np.asarray(fn(x8, q4, s4))
                    for part, unit in (("lo", [1.0, 0.0]), ("hi", [0.0, 1.0])):
                        s = jnp.broadcast_to(jnp.asarray(unit, jnp.float32)[:, None],
                                             s4.shape)
                        ref[f"{key}/{w}/{rows}/{part}"] = np.asarray(fn(x8, q4, s))
        codes, scales = pu2.quant_act(jnp.asarray(inp["act"]).astype(jnp.bfloat16))
        ref["quant/codes"] = np.asarray(codes)
        ref["quant/scales"] = np.asarray(scales.astype(jnp.float32))
    ref["body"] = _bodies(pu2, inp["body/x"], [inp[f"body/{k}"] for k in ("gu8", "gs8", "dn8", "ds8")],
                          [inp[f"body/{k}"] for k in ("gu4", "gs4", "dn4", "ds4")])
    port = run_port("probe_unpack2", inp, tmp_path_factory.mktemp("torch_probe_unpack2"))
    # The tool's first layer from x0 on the weights it drew, through the
    # probe's bodies.
    st = {k[len("stack/"):]: v for k, v in port.items() if k.startswith("stack/")}
    ref["run"] = _bodies(pu2, np.full((1, HIDDEN), 0.01, np.float32),
                         [st["gu8"][0], st["gs8"][0], st["dn8"][0], st["ds8"][0]],
                         [st["gu_q"][0], st["gu_s"][0], st["dn_q"][0], st["dn_s"][0]])
    return inp, ref, port


@pytest.mark.parametrize("name", L_CASES)
def test_byte_sum_matches_stream_kernel(sides, name):
    _, ref, port = sides
    assert port[f"L/{name}"].dtype == np.int32 and port[f"L/{name}"].shape == (1, 1)
    np.testing.assert_array_equal(port[f"L/{name}"], ref[f"L/{name}"])


def test_byte_sum_wraps_past_two_to_the_31(sides):
    inp, _, port = sides
    total = int(inp["l/wrap"].astype(np.int64).sum())
    assert total > 2 ** 31
    assert int(port["L/wrap"][0, 0]) == (total + 2 ** 31) % 2 ** 32 - 2 ** 31


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("w", WEIGHTS)
def test_int8_dot_matches_i8dot_kernel_bit_for_bit(sides, w, rows):
    _, ref, port = sides
    np.testing.assert_array_equal(port[f"M/{w}/{rows}"], ref[f"M/{w}/{rows}"])


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("w", WEIGHTS)
@pytest.mark.parametrize("kernel", ["O", "P"])
def test_int4_to_int8_integer_sums_exact(sides, kernel, w, rows):
    _, ref, port = sides
    for part in ("lo", "hi"):
        got, want = port[f"{kernel}/{w}/{rows}/{part}"], ref[f"{kernel}/{w}/{rows}/{part}"]
        assert np.abs(want).max() < 2 ** 24 and np.all(want == np.round(want))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("w", WEIGHTS)
@pytest.mark.parametrize("kernel", ["O", "P"])
def test_int4_to_int8_output_within_one_fma_rounding(sides, kernel, w, rows):
    inp, ref, port = sides
    s = inp[f"q4/{w}s"]
    lo, hi = ref[f"{kernel}/{w}/{rows}/lo"], ref[f"{kernel}/{w}/{rows}/hi"]
    room = (np.abs(lo * s[0]) + np.abs(hi * s[1])).max()
    err = np.abs(port[f"{kernel}/{w}/{rows}"] - ref[f"{kernel}/{w}/{rows}"]).max()
    assert err <= 2.0 ** -22 * room, (err, room)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("w", WEIGHTS)
def test_offset_and_signed_nibbles_are_two_functions(sides, w, rows):
    _, _, port = sides
    assert np.abs(port[f"O/{w}/{rows}"] - port[f"P/{w}/{rows}"]).max() > 0.0


@pytest.mark.parametrize("kernel", ["O", "P"])
def test_card_nibble_expansion_matches_probe_reading(kernel):
    """The card kernel (csrc/int_dot.cu nibbles_s8) turns a word of four
    packed bytes into four int8 at once: ((w >> shift) & 0x0F0F0F0F ^ flip)
    + 0x78787878, then ^ 0x80808080, flip 0 for O and 0x08080808 for P.  On
    every byte value it must give the probe kernels' readings, written as
    their Pallas bodies write them (_q4i8_kernel, _q4i8s_kernel)."""
    words = np.arange(256, dtype=np.uint8).view("<u4")  # byte k of word i: 4i + k
    flip = {"O": 0, "P": 0x08080808}[kernel]

    def expand(shift):
        out = ((((words >> shift) & 0x0F0F0F0F) ^ flip) + 0x78787878) ^ 0x80808080
        return out.astype("<u4").view(np.int8)

    q = jnp.arange(256, dtype=jnp.int32).astype(jnp.uint8)
    if kernel == "O":
        b = q.astype(jnp.int32)
        want_lo, want_hi = (b & 15) - 8, (b >> 4) - 8
    else:
        b8 = jax.lax.bitcast_convert_type(q, jnp.int8)
        want_lo, want_hi = (b8 << 4) >> 4, b8 >> 4
    np.testing.assert_array_equal(expand(0), np.asarray(want_lo, dtype=np.int8))
    np.testing.assert_array_equal(expand(4), np.asarray(want_hi, dtype=np.int8))


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("w", WEIGHTS)
def test_mixed_dot_runs_on_kernel_d(sides, w, rows):
    _, ref, port = sides
    want = ref[f"N/{w}/{rows}"]
    err = np.abs(port[f"N/{w}/{rows}"] - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err


@pytest.mark.parametrize("part", ["codes", "scales"])
def test_quant_act_bit_exact(sides, part):
    _, ref, port = sides
    assert port[f"quant/{part}"].dtype == ref[f"quant/{part}"].dtype
    np.testing.assert_array_equal(port[f"quant/{part}"], ref[f"quant/{part}"])


@pytest.mark.parametrize("key", ["F", "G", "H", "I"])
def test_layer_body_matches_probe_body(sides, key):
    inp, ref, port = sides
    want = ref["body"][key]
    assert np.isfinite(port[f"body/{key}"]).all()
    err = np.abs(port[f"body/{key}"] - want).max()
    assert err <= 2.0 ** -6 * np.abs(want).max(), err
    # d is of the order of h here, so the bound sees the matmuls.
    assert np.abs(want - inp["body/x"]).max() > 0.1 * np.abs(want).max()


@pytest.mark.parametrize("key", ["F", "G", "H", "I"])
def test_run_first_layer_matches_probe_body(sides, key):
    _, ref, port = sides
    want = ref["run"][key]
    got = port[f"run/{key}/layer"]
    assert got.shape == (1, HIDDEN) and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= 2.0 ** -6 * np.abs(want).max(), err


def test_stream_variant_returns_the_stack_sum(sides):
    _, _, port = sides
    total = sum(int(port[f"stack/{k}"].astype(np.int64).sum()) for k in ("gu_q", "dn_q"))
    assert int(port["run/S"][0, 0]) == (total + 2 ** 31) % 2 ** 32 - 2 ** 31
    layer0 = sum(int(port[f"stack/{k}"][0].astype(np.int64).sum()) for k in ("gu_q", "dn_q"))
    assert int(port["run/S/layer"][0, 0]) == (layer0 + 2 ** 31) % 2 ** 32 - 2 ** 31


@pytest.mark.parametrize("key", ["S", "F", "G", "H", "I"])
def test_probe_unpack2_run_launches_no_kernel_on_cpu(sides, key):
    _, _, port = sides
    assert json.loads(str(port[f"run/{key}/launches"])) == {}
