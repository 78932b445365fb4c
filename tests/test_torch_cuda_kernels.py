"""The port's CUDA kernels against their plain versions on the card, at small
and ragged shapes the slice does not reach (odd row counts, widths that are
no multiple of the block, a batch row with no valid key).  They need an
NVIDIA GPU and nvcc, and skip elsewhere:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the int4 and int8 kernels differ from their plain version
only in the order of the f32 sums, max|err| <= 1e-4 * max|y|, and int8
rows padded with zeros (scale 0) give exactly 0; the fused int8 MLP (E)
returns bf16 and rounds h to bf16 inside, so a sum in another order can
move an element of h or of y by one bf16 step: max|err| <= 2^-7 * max|y|,
which the same kernel with gate and up swapped must exceed, and two runs
must agree bit for bit (no atomics).  The int4 probe kernels: the folded
pair (F, I, J) and signed int4 (K) differ from their plain versions only in
the order of the f32 sums, max|err| <= 1e-4 * max|y|, and K with its
nibble order flipped must miss that; the fused slab MLP (H) rounds act to
bf16 inside, so a flip of one act value in 32 is allowed, max|err| <=
2^-12 * max_o sum_i |act_i w_oi| + 1e-4 * max|y|, which the same kernel
with one slab's gate and up swapped must exceed, and two runs must agree
bit for bit.  Kernels A and B give the same output bits as before the
folded kernels were added to their source (SHA-256 of their outputs on
seeded inputs, measured on an NVIDIA H100 80GB HBM3 with the parent
source).  Flash attention reads and
writes bf16 (unit-normal inputs) and rounds its probabilities before the
P.V product; all query rows are compared, to max|err| <= 2e-2 and each
output row to max|err| <= 2^-6 * max|ref| over that row, as chip_smoke.py
holds it.
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
}
Q8_CASES = {  # name: (rows, out, in, zero-padded rows at the end)
    "1x200x512": (1, 200, 512, 8),
    "3x1000x4096": (3, 1000, 4096, 40),  # two 2048-column x stages
    "9x64x2064": (9, 64, 2064, 0),       # two batch passes, a 16-column last stage
    "128x40x16": (128, 40, 16, 3),
    "5x33x4112": (5, 33, 4112, 1),
}
E_CASES = {  # name: (rows, hidden, inter)
    "1x256x384": (1, 256, 384),
    "3x512x208": (3, 512, 208),       # inter not a multiple of the 16-column block
    "8x2064x512": (8, 2064, 512),     # two x stages, a 16-column last stage
    "9x1024x2816": (9, 1024, 2816),   # two batch passes; the small profile's MLP
    "128x256x128": (128, 256, 128),
}
FOLD_CASES = {  # name: (rows, out, in, stacked layers or 0)
    "single-1x200x512": (1, 200, 512, 0),
    "single-9x1000x256": (9, 1000, 256, 0),   # two batch passes
    "single-128x64x1024": (128, 64, 1024, 0),
    "stacked-3x520x768": (3, 520, 768, 3),
}
I4_CASES = {  # name: (rows, out, in)
    "1x200x512": (1, 200, 512),
    "9x1000x256": (9, 1000, 256),
    "128x64x1024": (128, 64, 1024),
}
H_CASES = {  # name: (rows, hidden, inter, slab rows)
    "1x256x512x128": (1, 256, 512, 128),
    "9x512x384x96": (9, 512, 384, 96),        # two batch passes, 3-chunk slab rows
    "8x3584x2368x1184": (8, 3584, 2368, 1184),  # the probe's hidden and slab width
    "128x256x256x32": (128, 256, 256, 32),
}
AB_CASES = {  # name: (rows, out, in, stacked layers or 0); B single, A stacked
    "B-3x4096x3584": (3, 4096, 3584, 0),
    "A-8x4608x3584": (8, 4608, 3584, 2),
}
AB_BITS = {
    "B-3x4096x3584": "1f67c89d4ac7547d19d8f6c1232de9d59dddbcced96d196bf9ad242cf6b7a2df",
    "A-8x4608x3584": "f23af955dd4e9ba2d9ecd6ca0777ff09c706de484cf23740df83844715899900",
}
FLASH_CASES = {  # name: (head_dim, causal, per-batch lengths or None); b=2, s=256, h=3
    f"d{d}-{'causal' if causal else 'full'}-{'all' if lens is None else 'ragged'}":
        (d, causal, lens)
    for d in (64, 80) for causal in (False, True) for lens in (None, (200, 0))
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
                                    "ab_cases": np.array(json.dumps(AB_CASES))},
                   tmp_path_factory.mktemp("torch_cuda_kernels"))
    if str(out["skip"]):
        pytest.skip(str(out["skip"]))
    return out


@pytest.mark.parametrize("name", list(Q4_CASES))
def test_q4_kernel_matches_plain(card, name):
    err, scale = card[f"q4/{name}"].tolist()
    assert err <= 1e-4 * scale, (err, scale)


@pytest.mark.parametrize("name", list(Q8_CASES))
def test_q8_kernel_matches_plain(card, name):
    err, scale, padded = card[f"q8/{name}"].tolist()
    assert err <= 1e-4 * scale, (err, scale)
    assert padded == 0.0


@pytest.mark.parametrize("name", list(E_CASES))
def test_fused_mlp_kernel_matches_plain(card, name):
    err, scale, swapped, repeatable = card[f"e/{name}"].tolist()
    assert err <= 2.0 ** -7 * scale, (err, scale)
    assert swapped > 2.0 ** -7 * scale, (swapped, scale)
    assert repeatable == 1.0


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_kernel_matches_plain(card, name):
    row_err, err, empty_row = card[f"flash/{name}"].tolist()
    assert err <= 2e-2, err
    assert row_err <= 2.0 ** -6, row_err
    assert empty_row == 0.0


@pytest.mark.parametrize("name", list(FOLD_CASES))
def test_folded_kernel_matches_plain(card, name):
    err, scale = card[f"fold/{name}"].tolist()
    assert err <= 1e-4 * scale, (err, scale)


@pytest.mark.parametrize("name", list(I4_CASES))
def test_i4_kernel_matches_plain(card, name):
    err, scale, flipped = card[f"i4/{name}"].tolist()
    assert err <= 1e-4 * scale, (err, scale)
    assert flipped > 1e-4 * scale, (flipped, scale)


@pytest.mark.parametrize("name", list(H_CASES))
def test_fused_slab_mlp_kernel_matches_plain(card, name):
    err, scale, act_w, swapped, repeatable = card[f"h/{name}"].tolist()
    tol = 2.0 ** -12 * act_w + 1e-4 * scale
    assert err <= tol, (err, tol)
    assert swapped > tol, (swapped, tol)
    assert repeatable == 1.0


def test_fold_flag_leaves_kernels_a_and_b_bit_for_bit(card):
    assert json.loads(str(card["ab_bits"])) == AB_BITS


def test_kernels_refuse_what_they_do_not_take(card):
    assert json.loads(str(card["refused"])) == {
        "q4_rows": "ValueError", "q8_rows": "ValueError", "q8_in16": "ValueError",
        "q8_u8": "TypeError", "e_rows": "ValueError", "e_shape": "ValueError",
        "e_u8": "TypeError", "flash_f32": "TypeError", "flash_d96": "ValueError",
        "fold_scale_rows": "ValueError", "i4_rows": "ValueError", "h_slab24": "ValueError"}


def test_each_case_counted_one_launch(card):
    assert card["launches"].tolist() == [
        sum(1 for *_, layers in Q4_CASES.values() if not layers),
        sum(1 for *_, layers in Q4_CASES.values() if layers),
        len(FLASH_CASES),
        len(Q8_CASES),
        3 * len(E_CASES),  # the checked run, the gate/up-swapped run, the repeat
        sum(1 for *_, layers in FOLD_CASES.values() if not layers),
        sum(1 for *_, layers in FOLD_CASES.values() if layers),
        2 * len(I4_CASES),  # the checked run and the flipped-nibble run
        3 * len(H_CASES),   # the checked run, the swapped-slab run, the repeat
    ]
