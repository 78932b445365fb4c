"""The lookahead window pass of ``vis_tpu_torch/models/common/decoder.py``
against the list-driven code it replaced.

``WindowPass`` runs each window from static buffers through
``_extend_pass``, which reads no host value so that the card can replay it
as one CUDA graph; on the CPU every window runs eagerly from the same
buffers.  The reference (torch_port_runner.py ``window_pass``) is the
previous ``extend_scan`` and ``lookahead_decode`` verbatim: cursors from the
host mirror, per-row slice writes, the last index and the position update
sent from host lists, the cursor tensor rebound.  Pinned here, exactly, on
the tiny Qwen2.5-VL text stack (M-RoPE) and the tiny Llama:

- one pass: two rows at different cursors, short valid spans, a row
  frozen after a window (its cursor put back in place), then a chat-sized
  chunk through ``extend_scan``: every window's logits, the K/V bytes, the
  device cursors and the host mirror; the pass still binds the cache's
  cursor tensor after the freeze;
- a request's decode: ``decode_loop_lookahead`` chained call after call
  (one pass per request, kept by the cache) against the reference, greedy
  and with the same uniforms sampled, one row or two rows whose budgets
  differ (the first freezes while the second decodes on): tokens, valid
  masks, cursors, host mirror, final logits and K/V bytes;
- the kernels' launch counts across a capture: none while capturing, the
  capture's tally at each replay.
"""

import json

import numpy as np
import pytest

from torch_port import run_port

MODELS = ("qwen", "llama")
WINDOW = 8
# Valid lengths of each window's two rows; row 1 freezes after window 2.
SCHEDULE = [[8, 3], [1, 8], [5, 1], [2, 6], [8, 8]]
# (rows, mode, windows a call): one row over many short calls, two rows in
# one call long enough for both budgets.
DECODES = [[1, "greedy", 3], [1, "sampled", 3], [2, "greedy", 400], [2, "sampled", 400]]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    cases = {"window": WINDOW, "body": {"schedule": SCHEDULE, "frozen_after": 2},
             "decode": DECODES}
    return run_port("window_pass", {"cases": np.array(json.dumps(cases))},
                    tmp_path_factory.mktemp("window_pass"))


def _equal(port, prefix, key):
    np.testing.assert_array_equal(port[f"{prefix}/new/{key}"], port[f"{prefix}/ref/{key}"],
                                  err_msg=f"{prefix} {key}")


@pytest.mark.parametrize("model", MODELS)
def test_window_logits_equal_the_list_driven_extend(port, model):
    for w in range(len(SCHEDULE)):
        _equal(port, f"{model}/body", f"logits{w}")
    _equal(port, f"{model}/body", "chunk")


@pytest.mark.parametrize("model", MODELS)
def test_window_kv_bytes_equal_the_list_driven_extend(port, model):
    for key in ("k", "v"):
        _equal(port, f"{model}/body", key)


@pytest.mark.parametrize("model", MODELS)
def test_window_cursors_move_in_place(port, model):
    _equal(port, f"{model}/body", "lengths")
    _equal(port, f"{model}/body", "lengths_host")
    np.testing.assert_array_equal(port[f"{model}/body/new/lengths"],
                                  port[f"{model}/body/new/lengths_host"])
    # Windows of 29 and 20 valid tokens (row 1 frozen after its third),
    # then the chunk's 16 and 9.
    assert port[f"{model}/body/new/lengths_host"].tolist() == [13 + 24 + 16, 29 + 25 + 9]
    assert bool(port[f"{model}/body/bound"])


@pytest.mark.parametrize("rows,mode,windows", DECODES,
                         ids=[f"{r}row-{m}" for r, m, _ in DECODES])
@pytest.mark.parametrize("model", MODELS)
def test_decode_equals_todays_lookahead(port, model, rows, mode, windows):
    prefix = f"{model}/decode{rows}_{mode}"
    for key in ("tokens", "valid", "logits", "k", "v", "lengths", "lengths_host", "calls"):
        _equal(port, prefix, key)
    valid = port[f"{prefix}/new/valid"]
    assert valid.sum() > 0
    # Every window of every call went through the request's one pass.
    assert int(port[f"{prefix}/new/windows"]) == int(valid.any(axis=(0, 2)).sum())
    if rows == 1:
        assert int(port[f"{prefix}/new/calls"]) > 1
    else:
        # The first row froze: the second decoded windows after its EOS.
        ends = [int(np.flatnonzero(valid[r].any(axis=1))[-1]) for r in range(2)]
        assert ends[0] < ends[1]


def test_a_capture_counts_its_launches_at_each_replay():
    """A kernel wrapper called while its thread captures a CUDA graph
    launches nothing: the call goes to the capture's tally, not to the
    wrapper's ``launches``, while another thread's calls still count; each
    replay then adds the tally (``vis_tpu_torch/ops/_kernels.py``)."""
    import threading

    from vis_tpu_torch.ops import _kernels

    def kernel():
        _kernels.count_launch(kernel)

    kernel.launches = 0
    elsewhere = threading.Thread(target=lambda: [kernel() for _ in range(3)])
    with _kernels.captured_launches() as tally:
        kernel()
        kernel()
        elsewhere.start()
        elsewhere.join()
    assert tally == {kernel: 2}
    assert kernel.launches == 3
    kernel()
    for _ in range(2):
        _kernels.add_launches(tally)
    assert kernel.launches == 3 + 1 + 2 * 2
