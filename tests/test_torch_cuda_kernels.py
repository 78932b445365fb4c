"""The port's CUDA kernels against their plain versions on the card, at small
and ragged shapes the slice does not reach (odd row counts, widths that are
no multiple of the block, a batch row with no valid key).  They need an
NVIDIA GPU and nvcc, and skip elsewhere:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the int4 and int8 kernels differ from their plain version
only in the order of the f32 sums, max|err| <= 1e-4 * max|y|, and int8
rows padded with zeros (scale 0) give exactly 0; flash attention reads and
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
FLASH_CASES = {  # name: (head_dim, causal, per-batch lengths or None); b=2, s=256, h=3
    f"d{d}-{'causal' if causal else 'full'}-{'all' if lens is None else 'ragged'}":
        (d, causal, lens)
    for d in (64, 80) for causal in (False, True) for lens in (None, (200, 0))
}


@pytest.fixture(scope="module")
def card(tmp_path_factory):
    out = run_port("cuda_kernels", {"q4_cases": np.array(json.dumps(Q4_CASES)),
                                    "q8_cases": np.array(json.dumps(Q8_CASES)),
                                    "flash_cases": np.array(json.dumps(FLASH_CASES))},
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


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_kernel_matches_plain(card, name):
    row_err, err, empty_row = card[f"flash/{name}"].tolist()
    assert err <= 2e-2, err
    assert row_err <= 2.0 ** -6, row_err
    assert empty_row == 0.0


def test_kernels_refuse_what_they_do_not_take(card):
    assert json.loads(str(card["refused"])) == {
        "q4_rows": "ValueError", "q8_rows": "ValueError", "q8_in16": "ValueError",
        "q8_u8": "TypeError", "flash_f32": "TypeError", "flash_d96": "ValueError"}


def test_each_case_counted_one_launch(card):
    assert card["launches"].tolist() == [
        sum(1 for *_, layers in Q4_CASES.values() if not layers),
        sum(1 for *_, layers in Q4_CASES.values() if layers),
        len(FLASH_CASES),
        len(Q8_CASES),
    ]
