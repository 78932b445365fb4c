"""The int4 probe tools' kernels in the PyTorch port against the JAX probes'
Pallas kernels, run in this process in interpret mode
(``pltpu.force_tpu_interpret_mode()``) on the same inputs; the port side
runs on the CPU in a subprocess (see torch_port.py), where every wrapper
takes its plain version.  Shapes are small: 2 layers, hidden 256, inter
512, slabs of 128 intermediate rows, output dims multiples of 128 as the
probes' block picker needs.

Tolerances:

- F (``_q4_stacked_folded_kernel``), J (``_q4_matmul_kernel_folded``), I
  (``flat_folded``, J's body, on a head padded from 384 to 512 rows) and K
  (``_i4_matmul_kernel``) compute the TPU body's arithmetic exactly, so
  they agree up to the order of the f32 sums: max|err| <= 1e-4 * max|y|.
  Padded head rows are exactly 0 on both sides.
- The same three against the order in which the card's kernel sums the
  folded function, written out in torch: the exact (n - 8) times bf16 x,
  one f32 sum per nibble half, each scaled after it is complete.  The TPU
  body sums x . n and subtracts 8 sum x instead; the two agree within
  1e-4 * max|y| on the test's x and on the probes' constant x0 = 0.01,
  where x . n and 8 sum x nearly cancel.
- G (``probe_stacked_fused._q4_stacked_kernel``) and Q
  (``probe_scan_slice._q4_stacked_kernel``) run on the port's kernel A,
  which rounds each (n - 8) * s to bf16; they are held to the bound A
  meets against the TPU body: 2^-8 * max_o sum_i |x_i w_oi| + 1e-4 * max|y|.
- H (``_q4_fused_mlp_kernel``): a sum taken in another order can move
  act_i = bf16(g * sigmoid(g) * u) across a bf16 rounding boundary, and
  one such flip changes y_o by at most ulp(act_i) * |w_oi| <= 2^-7 *
  |act_i w_oi|.  Bound: max|err| <= 2^-12 * max_o sum_i |act_i w_oi| +
  1e-4 * max|y|, a flip of one in 32 act values (w the down weight as the
  slab layout's scales apply it).

``q4_fused_mlp`` in the probe cannot run the kernel: it unpacks a 3-D
shape from ``gq`` (``probe_stacked_fused.py:191``) while the probe hands it
the 4-D slab array, so variant F fails on every backend.  The test builds
the same ``pallas_call`` (the probe's BlockSpecs, its ``fixed`` wrapper and
kernel body) with the shapes read from the 4-D arrays.  The slab repack is
nested in the probe's ``main``; ``_jax_repack`` is a copy of it.
"""

import importlib.util
import json
from functools import partial
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from torch_port import run_port

REPO = Path(__file__).resolve().parents[1]
LAYERS, HIDDEN, INTER, BI, HEAD = 2, 256, 512, 128, 384
ROWS = (1, 3)


def _probe(name):
    """A probe tool (tools/ is no package) loaded as a module."""
    spec = importlib.util.spec_from_file_location(f"tools_{name}", REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _fused_mlp(x, gq2, gs2, dq2, ds2, layer_idx, inter_block):
    """probe_stacked_fused.q4_fused_mlp's pallas_call over the 4-D slab
    arrays: its BlockSpecs, ``fixed`` wrapper and kernel body."""
    psf = _probe("probe_stacked_fused")
    _, _, _, halfh = gq2.shape
    hidden = 2 * halfh
    batch = x.shape[0]
    blocks = gq2.shape[1]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(blocks,),
        in_specs=[
            pl.BlockSpec((batch, hidden), lambda j, idx: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, 2 * inter_block, halfh), lambda j, idx: (idx[0], j, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, 2, 2 * inter_block), lambda j, idx: (idx[0], j, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, hidden, inter_block // 2), lambda j, idx: (idx[0], j, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, 2, hidden), lambda j, idx: (idx[0], j, 0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((batch, hidden), lambda j, idx: (0, 0), memory_space=pltpu.VMEM),
    )
    kernel = partial(psf._q4_fused_mlp_kernel, inter_block=inter_block)

    def fixed(idx_ref, x_ref, gq_ref, gs_ref, dq_ref, ds_ref, o_ref):
        kernel(idx_ref, x_ref, gq_ref[:, 0], gs_ref[:, 0], dq_ref[:, 0], ds_ref[:, 0], o_ref)

    return pl.pallas_call(
        fixed, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((batch, hidden), jnp.float32),
    )(jnp.asarray([layer_idx], jnp.int32), x.astype(jnp.bfloat16), gq2, gs2, dq2, ds2)


def _jax_repack(guq, gus, dnq, dns, layers, hidden, inter, bi):
    """A copy of the probe's repack (probe_stacked_fused.py:294-319)."""
    blocks = inter // bi
    gate = guq[:, :inter].reshape(layers, blocks, bi, hidden // 2)
    up = guq[:, inter:].reshape(layers, blocks, bi, hidden // 2)
    gq2 = jnp.concatenate([gate, up], axis=2)
    gs_gate = gus[:, :, :inter].reshape(layers, 2, blocks, bi)
    gs_up = gus[:, :, inter:].reshape(layers, 2, blocks, bi)
    gs2 = jnp.concatenate([gs_gate, gs_up], axis=3).transpose(0, 2, 1, 3)
    lo = (dnq & 15).astype(jnp.uint8)
    hi = (dnq >> 4).astype(jnp.uint8)
    full = jnp.concatenate([lo, hi], axis=-1)
    slab = full.reshape(layers, hidden, blocks, bi).transpose(0, 2, 1, 3)
    dq2 = slab[..., : bi // 2] | (slab[..., bi // 2:] << 4)
    ds2 = jnp.broadcast_to(dns[:, None], (layers, blocks, 2, hidden))
    return gq2, gs2, dq2, ds2


def _dequant(q, s2):
    """Split-half int4 q [O, half] with scales [2, O] -> w [O, 2*half] f32."""
    q = q.astype(np.int32)
    lo = ((q & 15) - 8) * s2[0][:, None]
    hi = ((q >> 4) - 8) * s2[1][:, None]
    return np.concatenate([lo, hi], axis=1).astype(np.float32)


def _bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    psf, pss, pu = _probe("probe_stacked_fused"), _probe("probe_scan_slice"), _probe("probe_unpack")
    rng = np.random.default_rng(41)
    inp = {
        "gu_q": rng.integers(0, 256, (LAYERS, 2 * INTER, HIDDEN // 2), dtype=np.uint8),
        "gu_s": (0.01 + 0.01 * rng.random((LAYERS, 2, 2 * INTER))).astype(np.float32),
        "dn_q": rng.integers(0, 256, (LAYERS, HIDDEN, INTER // 2), dtype=np.uint8),
        "dn_s": (0.01 + 0.01 * rng.random((LAYERS, 2, HIDDEN))).astype(np.float32),
        "k_w": rng.integers(-7, 8, (2 * INTER, HIDDEN)).astype(np.int8),
        "k_s": (0.01 + 0.01 * rng.random((1, 2 * INTER))).astype(np.float32),
        "inter_block": np.array(BI),
        "rows": np.array(ROWS),
    }
    head_q = rng.integers(0, 256, (HEAD, HIDDEN // 2), dtype=np.uint8)
    head_s = (0.01 + 0.01 * rng.random((2, HEAD))).astype(np.float32)
    inp["head_q"] = np.pad(head_q, ((0, 512 - HEAD), (0, 0)))  # as the probe pads its head
    inp["head_s"] = np.pad(head_s, ((0, 0), (0, 512 - HEAD)))
    gu_q, gu_s, dn_q, dn_s = (jnp.asarray(inp[k]) for k in ("gu_q", "gu_s", "dn_q", "dn_s"))
    slabs = _jax_repack(gu_q, gu_s, dn_q, dn_s, LAYERS, HIDDEN, INTER, BI)
    for name, value in zip(("gq2", "gs2", "dq2", "ds2"), slabs):
        inp[f"jax_slab/{name}"] = np.asarray(value)
    ref = {}
    with pltpu.force_tpu_interpret_mode():
        for rows in ROWS:
            x = rng.standard_normal((rows, HIDDEN)).astype(np.float32)
            a = rng.standard_normal((rows, INTER)).astype(np.float32)
            inp[f"x{rows}"], inp[f"a{rows}"] = x, a
            xj, aj = jnp.asarray(x), jnp.asarray(a)
            ref[f"F/{rows}"] = np.asarray(psf.q4_stacked(xj, gu_q, gu_s, 1,
                                                         psf._q4_stacked_folded_kernel))
            ref[f"G/{rows}"] = np.asarray(psf.q4_stacked(xj, gu_q, gu_s, 1, psf._q4_stacked_kernel))
            ref[f"Q/{rows}"] = np.asarray(pss.q4_matmul_stacked(aj, dn_q, dn_s, 1))
            ref[f"J/{rows}"] = np.asarray(pu.q4_matmul_folded(aj, dn_q[0], dn_s[0]))
            ref[f"I/{rows}"] = np.asarray(pu.q4_matmul_folded(
                xj, jnp.asarray(inp["head_q"]), jnp.asarray(inp["head_s"])))
            ref[f"K/{rows}"] = np.asarray(pu.i4_matmul(
                xj, jnp.asarray(inp["k_w"]).astype(jnp.int4), jnp.asarray(inp["k_s"])))
            ref[f"H/{rows}"] = np.asarray(_fused_mlp(xj, *slabs, 1, BI))
            ref[f"G/{rows}/bound"] = (np.abs(_bf16(x)) @ np.abs(
                _dequant(inp["gu_q"][1], inp["gu_s"][1])).T).max()
            ref[f"Q/{rows}/bound"] = (np.abs(_bf16(a)) @ np.abs(
                _dequant(inp["dn_q"][1], inp["dn_s"][1])).T).max()
        # The probes' own first input, a constant 0.01 (tools/_probe's x0).
        inp["x0"] = np.full((1, HIDDEN), 0.01, np.float32)
        inp["a0"] = np.full((1, INTER), 0.01, np.float32)
        x0, a0 = jnp.asarray(inp["x0"]), jnp.asarray(inp["a0"])
        ref["F/x0"] = np.asarray(psf.q4_stacked(x0, gu_q, gu_s, 1, psf._q4_stacked_folded_kernel))
        ref["J/x0"] = np.asarray(pu.q4_matmul_folded(a0, dn_q[0], dn_s[0]))
        ref["I/x0"] = np.asarray(pu.q4_matmul_folded(
            x0, jnp.asarray(inp["head_q"]), jnp.asarray(inp["head_s"])))
    port = run_port("probes", inp, tmp_path_factory.mktemp("torch_probes"))
    return inp, ref, port


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("kernel", ["F", "J", "I", "K"])
def test_exact_arithmetic_matches_probe_kernel(sides, kernel, rows):
    _, ref, port = sides
    want = ref[f"{kernel}/{rows}"]
    err = np.abs(port[f"{kernel}/{rows}"] - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err


@pytest.mark.parametrize("inputs", [str(rows) for rows in ROWS] + ["x0"])
@pytest.mark.parametrize("kernel", ["F", "J", "I"])
def test_centred_order_matches_probe_kernel(sides, kernel, inputs):
    """The card kernel's order for the folded function (sums of x . (n - 8)
    per nibble half, scales after the sums) against the TPU body's."""
    _, ref, port = sides
    want = ref[f"{kernel}/{inputs}"]
    got = port[f"centred/{kernel}/{inputs}"]
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err


@pytest.mark.parametrize("rows", ROWS)
def test_padded_head_rows_exactly_zero(sides, rows):
    _, ref, port = sides
    assert np.abs(port[f"I/{rows}"][:, HEAD:]).max() == 0.0
    assert np.abs(ref[f"I/{rows}"][:, HEAD:]).max() == 0.0


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("kernel", ["G", "Q"])
def test_kernel_a_matches_probe_kernel_within_bf16_weight_rounding(sides, kernel, rows):
    _, ref, port = sides
    want = ref[f"{kernel}/{rows}"]
    err = np.abs(port[f"{kernel}/{rows}"] - want).max()
    bound = 2.0 ** -8 * ref[f"{kernel}/{rows}/bound"] + 1e-4 * np.abs(want).max()
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("rows", ROWS)
def test_fused_slab_mlp_matches_probe_kernel(sides, rows):
    _, ref, port = sides
    want = ref[f"H/{rows}"]
    err = np.abs(port[f"H/{rows}"] - want).max()
    bound = 2.0 ** -12 * float(port[f"H/{rows}/bound"]) + 1e-4 * np.abs(want).max()
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("name", ["gq2", "gs2", "dq2", "ds2"])
def test_repack_slabs_matches_probe_repack(sides, name):
    inp, _, port = sides
    np.testing.assert_array_equal(port[f"slab/{name}"], inp[f"jax_slab/{name}"])


def test_pack_int4_adjacent_round_trips_two_complement_nibbles(sides):
    inp, _, port = sides
    v = inp["k_w"].astype(np.int32)
    want = ((v[:, 0::2] & 15) | ((v[:, 1::2] & 15) << 4)).astype(np.uint8)
    np.testing.assert_array_equal(port["packed"], want)
    np.testing.assert_array_equal(port["unpacked"], inp["k_w"])


@pytest.mark.parametrize("rows", ROWS)
def test_fused_equals_unfused_with_equal_down_scales(sides, rows):
    _, _, port = sides
    err, scale, act_w = port[f"trap/equal/{rows}"].tolist()
    assert err <= 2.0 ** -12 * act_w + 1e-4 * scale, (err, scale, act_w)


@pytest.mark.parametrize("rows", ROWS)
def test_repack_trap_shows_with_unequal_down_scales(sides, rows):
    """The probe broadcasts the down scales' (lo, hi) rows to every slab, so
    with unequal lo / hi scales the fused MLP computes another function."""
    _, _, port = sides
    err, scale, act_w = port[f"trap/unequal/{rows}"].tolist()
    assert err > 2.0 ** -12 * act_w + 1e-4 * scale, (err, scale, act_w)


# Variants of one probe run that compute one function: (module, a, b, bound
# as a share of max|h|).  Scan A, B and D and the padded heads are the same
# arithmetic on the CPU; stacked D (kernel A's bf16-rounded weights) and E
# (exact) differ by the rounding of the bf16 residual, one bf16 step a layer
# (2^-7 * |h| each, 2 layers); F is E's function under the probe's uniform
# scales; unpack A and B are A's and the exact arithmetic.
RUN_PAIRS = [("scan", "A", "B", 0.0), ("scan", "A", "D", 0.0),
             ("unpack", "A", "B", 2.0 ** -6), ("fused", "D", "E", 2.0 ** -6),
             ("fused", "E", "F", 2.0 ** -6), ("fused", "H512", "H1024", 0.0),
             ("fused", "H512", "H2048", 0.0)]


@pytest.mark.parametrize("module,a,b,share", RUN_PAIRS, ids=lambda v: str(v))
def test_probe_variants_agree_on_cpu(sides, module, a, b, share):
    _, _, port = sides
    ha, hb = port[f"run/{module}/{a}"], port[f"run/{module}/{b}"]
    assert np.isfinite(ha).all() and np.isfinite(hb).all()
    assert np.abs(ha - hb).max() <= share * np.abs(ha).max()


# Variants whose first layer from x0 runs one function on the same bytes
# (every probe draws its int4 stack first from one seed): kernels A and B's
# arithmetic, the folded arithmetic, the padded heads.  chip_smoke.py holds
# them bit-equal on the card.
SAME_LAYER = [[("scan", k) for k in "ABCD"] + [("unpack", "A"), ("fused", "D")],
              [("unpack", "B"), ("fused", "E")],
              [("fused", f"H{b}") for b in (512, 1024, 2048)]]


@pytest.mark.parametrize("members", SAME_LAYER, ids=lambda m: "-".join(map("".join, m)))
def test_probe_first_layers_agree(sides, members):
    _, _, port = sides
    want = port[f"run/{members[0][0]}/{members[0][1]}/layer"]
    assert np.isfinite(want).all() and want.shape == (1, 256)
    for module, key in members[1:]:
        np.testing.assert_array_equal(port[f"run/{module}/{key}/layer"], want)


@pytest.mark.parametrize("module,key", [("scan", "A"), ("unpack", "B"), ("unpack", "C"),
                                        ("fused", "F")])
def test_probe_first_layer_is_one_layer_of_the_pass(sides, module, key):
    """``layer`` is the pass cut to one layer: a 2-layer pass moves h again."""
    _, _, port = sides
    layer, first = port[f"run/{module}/{key}/layer"], port[f"run/{module}/{key}"]
    assert np.isfinite(layer).all() and layer.shape == first.shape
    assert not np.array_equal(layer, first)


@pytest.mark.parametrize("module,variants", [("scan", "ABCD"), ("unpack", "ABCDE"),
                                             ("fused", ["D", "E", "F", "H512", "H1024",
                                                        "H2048"])])
def test_probe_runs_launch_no_kernel_on_cpu(sides, module, variants):
    _, _, port = sides
    for key in variants:
        assert json.loads(str(port[f"run/{module}/{key}/launches"])) == {}
