"""The port's CUDA kernels against their plain versions on the card, at small
and ragged shapes the slice does not reach (odd row counts, widths that are
no multiple of the block, a batch row with no valid key).  They need an
NVIDIA GPU and nvcc, and skip elsewhere:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py --noconftest

(``--noconftest`` on a machine with a card and no jax: the conftest imports
it).  Tolerances: the int4 and int8 kernels differ from their plain version
only in the order of the f32 sums, max|err| <= 1e-4 * max|y|, and int8
rows padded with zeros (scale 0) give exactly 0.  Kernel D (the int8
matmul) runs E's tensor-core matvec since it left its CUDA-core loop: its
cases take both models' qkv and o widths at every batch of 1 to 8 rows and
at 16, 32 and 128 (the K split across a block's warps, x read from L2 with
the weights at B <= 8 and staged in slabs above, more passes past 32
rows), and a row count that is no multiple of 16; every D case must repeat
bit for bit, and with two or more rows the same kernel with x's first two
rows swapped must miss the tolerance.  The fused int8 MLP (E, two
launches of that matvec: gate, up and SwiGLU, then down) returns
bf16 and rounds h to bf16 inside, so a sum in another order can move an
element of h or of y by one bf16 step: max|err| <= 2^-7 * max|y|, which the
same kernel with gate and up swapped must exceed, and two runs must agree
bit for bit (no atomics); its cases include one layer at Qwen2.5-VL-7B's
and Llama-3.1-8B's widths at every batch of 1 to 8 rows, and hidden and
intermediate sizes that are multiples of 16 but not of 64.  The int4 probe
kernels: the folded pair (F, I, J) and signed int4 (K, the signed form of
kernel A's matvec) differ from their plain versions only in the order of
the f32 sums, max|err| <= 1e-4 * max|y|, and K with its nibble order
flipped, or the folded pair with its s_lo and s_hi scale rows exchanged,
must miss that; both give the same bits twice.  The fused slab MLP (H)
runs kernel A's matvec since it left its CUDA-core kernels (a gated folded
form into act, the folded form once per slab, an ordered sum of the slabs):
it rounds act to bf16 inside, so a flip of one act value in 32 is allowed,
max|err| <= 2^-12 * max_o sum_i |act_i w_oi| + 1e-4 * max|y|, which the same
kernel with one slab's gate and up swapped must exceed, and two runs must
agree bit for bit; its cases include half a slab row that is no multiple of
64 bytes, up to 32 rows, and down scales that differ from slab to slab.  The int8 probe's kernels: the byte sum (L) equals its plain
version and torch.sum(dtype=int32) bit for bit, and the large cases wrap;
M, O and P have exact int32 sums and an epilogue of rounded (never fused)
operations, so they equal their plain versions bit for bit (O and P twice),
and O with its x halves swapped, or on P's reading of the bytes, must not.
O and P run kernel A's matvec in an integer form on mma.sync.m16n8k32 s8:
their cases take the probe's gate_up at B = 1 (a warp a tile), its down at
B = 1 and 8 (the K split), every batch of 1 to 8 rows and 16, 32 and 128
(two and four n-tiles, four passes), 1000 rows (no multiple of 16), half
rows that are multiples of 16 but not of 64 (a partial last chunk), and
extremes: x all +-127 and bytes 0x00, 0xFF, 0x88 and 0x77, where each
nibble reading reaches -8 and 7 and the sums their largest magnitude.  The outputs of
kernels A and B are pinned by SHA-256 digests of their bytes on seeded
inputs, measured on an NVIDIA H100 80GB HBM3.  Both were measured anew
when they moved to the tensor cores (A first, then B onto A's kernel):
the mma.sync kernel sums each output in another order than the
one-warp-a-row loop did (sixteen-input tensor-core products, the K splits
added in warp order), so its f32 bits differ from the loop's, within the
same 1e-4 * max|y| of the plain version.  B is the launch A makes for a
one-layer stack: every B case must equal A on the same weight bit for bit,
and give exactly 0 on rows padded with zeros (q 0, scale 0) as a vocab head
pads them.  Every int4 case runs twice and must give the same bits.  Flash attention reads and writes
bf16 (unit-normal inputs) and rounds its probabilities before the P.V
product; all query rows are compared, to max|err| <= 2e-2 and each output
row to max|err| <= 2^-6 * max|ref| over that row, as chip_smoke.py holds it,
a second run must give the same bits, and the cases include lengths inside
the first 64-key tile, on a tile edge and 0, a sequence of 192 (the
kernel's last 128-row query tile then holds 64 rows) and a negative
sm_scale (the wrapper folds its sign into q).
"""

import json

import numpy as np
import pytest

from torch_port import run_port

pytestmark = pytest.mark.cuda

Q4_CASES = {  # name: (rows, out, in, stacked layers or 0)
    "single-1x200x512": (1, 200, 512, 0),
    "single-3x1000x256": (3, 1000, 256, 0),
    "single-128x64x1024": (128, 64, 1024, 0),
    "stacked-2x72x32": (2, 72, 32, 3),
    "stacked-8x520x768": (8, 520, 768, 3),
    # Kernel A at B = 1, 3, 8, 9, 16 and 128 (one, two and four n-tiles, four
    # passes), O not a multiple of 16 x 8 warps, the Llama-3.1-8B widths (qkv,
    # and down with two x slabs), Qwen's down (nine slabs, 8 K splits), and
    # O past 2112 tiles (a warp a tile, 9-warp blocks; the last tile ragged).
    "stacked-1x200x512": (1, 200, 512, 2),
    "stacked-3x6144x4096": (3, 6144, 4096, 2),
    "stacked-3x4100x14336": (3, 4100, 14336, 2),
    "stacked-8x3584x18944": (8, 3584, 18944, 2),
    "stacked-5x37880x512": (5, 37880, 512, 2),
    "stacked-9x1000x256": (9, 1000, 256, 2),
    "stacked-16x520x4096": (16, 520, 4096, 2),
    "stacked-128x1000x1024": (128, 1000, 1024, 2),
}
Q8_CASES = {  # name: (rows, out, in, zero-padded rows at the end)
    "1x200x512": (1, 200, 512, 8),
    "3x1000x4096": (3, 1000, 4096, 40),
    "9x64x2064": (9, 64, 2064, 0),       # two n-tiles, a 16-column last chunk
    "128x40x16": (128, 40, 16, 3),       # four passes of four n-tiles, one chunk
    "5x33x4112": (5, 33, 4112, 1),       # out not a multiple of 16
    # Kernel D at the main path's qkv and o widths of Qwen2.5-VL-7B and
    # Llama-3.1-8B (224-384 tiles: K split across a block's warps), at every
    # batch of a window or a scheduler step, and at 16, 32 and 128 rows (two
    # and four n-tiles with x staged in slabs, four passes).
    **{f"{model}-{name}-{b}x{out}x{inn}": (b, out, inn, 16)
       for model, widths in (("qwen", ((4608, 3584), (3584, 3584))),
                             ("llama", ((6144, 4096), (4096, 4096))))
       for name, (out, inn) in zip(("qkv", "o"), widths)
       for b in (*range(1, 9), 16, 32, 128)},
}
E_CASES = {  # name: (rows, hidden, inter)
    "1x256x384": (1, 256, 384),
    "3x512x208": (3, 512, 208),       # inter not a multiple of 64 (a ragged last chunk)
    "8x2064x512": (8, 2064, 512),     # hidden not a multiple of 64
    "9x1024x2816": (9, 1024, 2816),   # two n-tiles; the small profile's MLP
    "128x256x128": (128, 256, 128),   # four passes of four n-tiles
    # Hidden and inter multiples of 16 but not of 64: ragged chunks in both
    # stages, and in stage 2 a slab that ends inside a chunk.
    "1x208x336": (1, 208, 336),
    "5x336x208": (5, 336, 208),
    "9x208x1104": (9, 208, 1104),
    "17x1040x336": (17, 1040, 336),
    "128x80x48": (128, 80, 48),
    # One layer at the main path's widths, every batch of a window or a
    # scheduler step: stage 1 a warp a tile, stage 2 K split 8 ways, h in slabs.
    **{f"qwen-{b}x3584x18944": (b, 3584, 18944) for b in range(1, 9)},
    **{f"llama-{b}x4096x14336": (b, 4096, 14336) for b in range(1, 9)},
}
FOLD_CASES = {  # name: (rows, out, in, stacked layers or 0)
    "single-1x200x512": (1, 200, 512, 0),
    "single-9x1000x256": (9, 1000, 256, 0),   # two batch passes
    "single-128x64x1024": (128, 64, 1024, 0),
    "stacked-3x520x768": (3, 520, 768, 3),
    "single-1x37880x512": (1, 37880, 512, 0),  # past 2112 tiles, the last one ragged
}
I4_CASES = {  # name: (rows, out, in); K runs the signed form of kernel A's matvec
    "1x200x512": (1, 200, 512),
    "9x1000x256": (9, 1000, 256),
    "128x64x1024": (128, 64, 1024),
    # B = 1, 3, 8, 9, 17, 32; out not a multiple of 16, in / 2 a multiple of
    # 16 but not of 64 (the last chunk ragged), and the probe's gate_up (a
    # warp a tile, 2368 tiles) and down (K split, three x slabs at B = 8).
    "1x37880x3584": (1, 37880, 3584),
    "3x1000x1056": (3, 1000, 1056),
    "8x3584x18944": (8, 3584, 18944),
    "9x200x96": (9, 200, 96),
    "17x1000x1056": (17, 1000, 1056),
    "32x520x96": (32, 520, 96),
}
H_CASES = {  # name: (rows, hidden, inter, slab rows, unequal per-slab down scales)
    "1x256x512x128": (1, 256, 512, 128, 0),
    "9x512x384x96": (9, 512, 384, 96, 0),        # two n-tiles, half a slab row 48 bytes
    "8x3584x2368x1184": (8, 3584, 2368, 1184, 0),  # the probe's hidden and slab width
    "128x256x256x32": (128, 256, 256, 32, 0),
    # Each slab's down scales its own (the probe's repack broadcasts one pair
    # to every slab), half a slab row not a multiple of 64 bytes (a partial
    # last chunk), B up to 32, and the probe's whole layer.
    "17x512x384x96-unequal": (17, 512, 384, 96, 1),
    "32x3584x2368x1184-unequal": (32, 3584, 2368, 1184, 1),
    "3x1024x768x192-unequal": (3, 1024, 768, 192, 1),
    "1x3584x18944x1184-unequal": (1, 3584, 18944, 1184, 1),
}
L_CASES = {  # name: (rows, width, fill byte or -1 for random bytes)
    "1x16": (1, 16, -1),
    "333x48": (333, 48, -1),
    "gate_up-37888x1792": (37888, 1792, -1),  # the probe's int4 gate_up, wraps
    "wrap-4096x2304": (4096, 2304, 255),
}
# name: (rows, out, in, extremes); M: q [out, in] int8, O and P: q [out, in/2]
# u8.  extremes: x all +-127 by row and the weight bytes 0x00, 0xFF, 0x88 and
# 0x77 by row (both nibble readings reach -8 and 7, and the sums their
# largest magnitude), else random bytes.
INT_CASES = {
    "1x200x512": (1, 200, 512, False),
    "3x1000x256": (3, 1000, 256, False),
    "8x72x4128": (8, 72, 4128, False),   # 3 x stages of M; O / P: a partial last chunk
    "9x40x96": (9, 40, 96, False),       # two batch passes
    "128x64x1024": (128, 64, 1024, False),
    "8x1000x256": (8, 1000, 256, False),
    # The probe's gate_up at B = 1 (a warp a tile) and down at B = 1 and 8
    # (K split across a block's warps).
    "1x37888x3584": (1, 37888, 3584, False),
    "1x3584x18944": (1, 3584, 18944, False),
    "8x3584x18944": (8, 3584, 18944, False),
    "8x3584x18944-extremes": (8, 3584, 18944, True),
    # Every batch of 1 to 8 rows, two and four n-tiles, four passes; 1000
    # rows (no multiple of 16) and half 784 (a partial last chunk).
    **{f"{rows}x1000x1568": (rows, 1000, 1568, False)
       for rows in (1, 2, 3, 4, 5, 6, 7, 8, 16, 32, 128)},
}
AB_CASES = {  # name: (rows, out, in, stacked layers or 0); B single, A stacked
    "B-3x4096x3584": (3, 4096, 3584, 0),
    "A-8x4608x3584": (8, 4608, 3584, 2),
}
AB_BITS = {
    "B-3x4096x3584": "68e0fdc1e8ffcda60adbc815f3cbcce847984cd54dabcd13f498ad64775232d3",
    "A-8x4608x3584": "60b4e63647270f65df0b89447fce1b07a262250a27deda9d1de09bb3f14f6e74",
}
FLASH_LENGTHS = {  # name: per-batch valid lengths (b=2) or None for all valid
    "all": None,
    "ragged": (200, 0),
    "edges": (37, 128),   # inside the first 64-key tile; on a tile edge
    "edge0": (64, 0),     # one whole tile; no valid key
}
FLASH_CASES = {  # name: (head_dim, causal, lengths, sequence length); b=2, h=3
    f"d{d}-{'causal' if causal else 'full'}-{lens}{'' if s == 256 else f'-s{s}'}":
        (d, causal, FLASH_LENGTHS[lens], s)
    for d in (64, 80) for causal in (False, True) for lens in FLASH_LENGTHS
    for s in (256, 192)  # 192: the kernel's last 128-row query tile holds 64 rows
}


@pytest.fixture(scope="module")
def card(tmp_path_factory):
    out = run_port("cuda_kernels", {"q4_cases": np.array(json.dumps(Q4_CASES)),
                                    "q8_cases": np.array(json.dumps(Q8_CASES)),
                                    "e_cases": np.array(json.dumps(E_CASES)),
                                    "flash_cases": np.array(json.dumps(FLASH_CASES)),
                                    "fold_cases": np.array(json.dumps(FOLD_CASES)),
                                    "i4_cases": np.array(json.dumps(I4_CASES)),
                                    "h_cases": np.array(json.dumps(H_CASES)),
                                    "ab_cases": np.array(json.dumps(AB_CASES)),
                                    "l_cases": np.array(json.dumps(L_CASES)),
                                    "int_cases": np.array(json.dumps(INT_CASES))},
                   tmp_path_factory.mktemp("torch_cuda_kernels"))
    if str(out["skip"]):
        pytest.skip(str(out["skip"]))
    return out


@pytest.mark.parametrize("name", list(Q4_CASES))
def test_q4_kernel_matches_plain(card, name):
    err, scale, repeatable = card[f"q4/{name}"].tolist()
    assert err <= 1e-4 * scale, (err, scale)
    assert repeatable == 1.0  # a second run gives the same bits


@pytest.mark.parametrize("name", [n for n, case in Q4_CASES.items() if not case[3]])
def test_b_is_a_on_a_one_layer_stack(card, name):
    padded, equal_to_a = card[f"q4_b/{name}"].tolist()
    assert padded == 0.0
    assert equal_to_a == 1.0


@pytest.mark.parametrize("name", list(Q8_CASES))
def test_q8_kernel_matches_plain(card, name):
    err, scale, padded, repeatable, swapped = card[f"q8/{name}"].tolist()
    assert err <= 1e-4 * scale, (err, scale)
    assert padded == 0.0
    assert repeatable == 1.0  # a second run gives the same bits
    if Q8_CASES[name][0] > 1:  # x's first two rows swapped must miss
        assert swapped > 1e-4 * scale, (swapped, scale)


@pytest.mark.parametrize("name", list(E_CASES))
def test_fused_mlp_kernel_matches_plain(card, name):
    err, scale, swapped, repeatable = card[f"e/{name}"].tolist()
    assert err <= 2.0 ** -7 * scale, (err, scale)
    assert swapped > 2.0 ** -7 * scale, (swapped, scale)
    assert repeatable == 1.0


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_kernel_matches_plain(card, name):
    row_err, err, empty_row, repeatable = card[f"flash/{name}"].tolist()
    assert err <= 2e-2, err
    assert row_err <= 2.0 ** -6, row_err
    assert empty_row == 0.0
    assert repeatable == 1.0


def test_flash_kernel_takes_a_negative_scale(card):
    assert card["flash_negative_scale"].item() <= 2.0 ** -6


@pytest.mark.parametrize("name", list(FOLD_CASES))
def test_folded_kernel_matches_plain(card, name):
    err, scale, repeatable, swapped = card[f"fold/{name}"].tolist()
    assert err <= 1e-4 * scale, (err, scale)
    assert repeatable == 1.0
    assert swapped > 1e-4 * scale, (swapped, scale)  # the lo and hi sums stay apart


@pytest.mark.parametrize("name", list(I4_CASES))
def test_i4_kernel_matches_plain(card, name):
    err, scale, flipped, repeatable = card[f"i4/{name}"].tolist()
    assert err <= 1e-4 * scale, (err, scale)
    assert flipped > 1e-4 * scale, (flipped, scale)
    assert repeatable == 1.0


@pytest.mark.parametrize("name", list(H_CASES))
def test_fused_slab_mlp_kernel_matches_plain(card, name):
    err, scale, act_w, swapped, repeatable = card[f"h/{name}"].tolist()
    tol = 2.0 ** -12 * act_w + 1e-4 * scale
    assert err <= tol, (err, tol)
    assert swapped > tol, (swapped, tol)
    assert repeatable == 1.0


@pytest.mark.parametrize("name", list(L_CASES))
def test_byte_sum_kernel_matches_plain(card, name):
    equal, library_equal, unwrapped_differs = card[f"l/{name}"].tolist()
    assert equal == 1.0 and library_equal == 1.0
    if name.startswith(("gate_up", "wrap")):
        assert unwrapped_differs == 1.0  # the sum passed 2^31 and wrapped


@pytest.mark.parametrize("name", list(INT_CASES))
def test_int8_activation_kernels_match_plain_bit_for_bit(card, name):
    m, o, o_again, p, p_again, o_swapped, o_as_p = card[f"int/{name}"].tolist()
    assert (m, o, o_again, p, p_again) == (1.0, 1.0, 1.0, 1.0, 1.0)
    assert o_swapped == 0.0 and o_as_p == 0.0


def test_fold_flag_leaves_kernels_a_and_b_bit_for_bit(card):
    assert json.loads(str(card["ab_bits"])) == AB_BITS


def test_kernels_refuse_what_they_do_not_take(card):
    assert json.loads(str(card["refused"])) == {
        "q4_rows": "ValueError", "q8_rows": "ValueError", "q8_in16": "ValueError",
        "q8_u8": "TypeError", "e_rows": "ValueError", "e_shape": "ValueError",
        "e_u8": "TypeError", "flash_f32": "TypeError", "flash_d96": "ValueError",
        "fold_scale_rows": "ValueError", "i4_rows": "ValueError", "h_slab24": "ValueError",
        "l_misaligned": "ValueError", "m_misaligned": "ValueError", "m_bf16": "TypeError",
        "o_scale_rows": "ValueError", "p_rows": "ValueError"}


def test_each_case_counted_one_launch(card):
    assert card["launches"].tolist() == [
        2 * sum(1 for *_, layers in Q4_CASES.values() if not layers),  # checked, repeated
        # Checked and repeated; each B case once more as a one-layer stack.
        2 * sum(1 for *_, layers in Q4_CASES.values() if layers)
        + sum(1 for *_, layers in Q4_CASES.values() if not layers),
        2 * len(FLASH_CASES) + 1,  # the checked run and the repeat; the negative scale
        # The checked run, the repeat, and with two rows the swapped run.
        2 * len(Q8_CASES) + sum(1 for rows, *_ in Q8_CASES.values() if rows > 1),
        3 * len(E_CASES),  # the checked run, the gate/up-swapped run, the repeat
        # The checked run, the repeat, the run with the scale rows swapped.
        3 * sum(1 for *_, layers in FOLD_CASES.values() if not layers),
        3 * sum(1 for *_, layers in FOLD_CASES.values() if layers),
        3 * len(I4_CASES),  # the checked run, the flipped-nibble run, the repeat
        3 * len(H_CASES),   # the checked run, the swapped-slab run, the repeat
        len(L_CASES),
        len(INT_CASES),
        3 * len(INT_CASES),  # the checked run, the repeat, x halves swapped
        2 * len(INT_CASES),  # the checked run, the repeat
    ]
