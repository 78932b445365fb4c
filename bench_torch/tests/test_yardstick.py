"""Generators repeat exactly for a seed, and the arithmetic is right on
synthetic inputs."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_torch.harness import timeline, work  # noqa: E402
from bench_torch.harness.photos import photo_array  # noqa: E402
from bench_torch.harness.serve import balanced  # noqa: E402
from bench_torch.families import _dense_gqa as dense_gqa  # noqa: E402
from bench_torch.harness.weights import _Plan, _numel, make_weights  # noqa: E402
from bench_torch.drivers import inspect  # noqa: E402

CONFIGS = ROOT / "bench_torch" / "configs"
TRAFFIC = ROOT / "bench_torch" / "traffic"


def _run(traffic, seed):
    return SimpleNamespace(traffic=json.loads((TRAFFIC / f"{traffic}.json").read_text()),
                           seed=seed)


def test_photo_plan_and_pixels_repeat_for_a_seed():
    a = inspect.plan_photos(_run("photo", 2**31 + 5), 12)
    b = inspect.plan_photos(_run("photo", 2**31 + 5), 12)
    c = inspect.plan_photos(_run("photo", 2**31 + 6), 12)
    assert a == b and a != c
    # Every seed serves the same mix of sizes: each block of three has all three.
    for plan in (a, c):
        for k in range(0, 12, 3):
            assert len({p["height"] * p["width"] for p in plan[k:k + 3]}) == 3
    assert np.array_equal(photo_array(a[3]), photo_array(b[3]))
    assert not np.array_equal(photo_array(a[3]), photo_array(dict(a[3], seed=7)))


def test_balanced_draws_keep_the_mix():
    draws = balanced(123, [0, 1, 2, 3, 4], 15, "defects")
    assert sorted(draws) == sorted([0, 1, 2, 3, 4] * 3)
    assert draws == balanced(123, [0, 1, 2, 3, 4], 15, "defects")


@pytest.mark.parametrize("traffic,key", [("photo", "sizes"), ("bundle", "defect_counts")])
def test_every_block_of_a_mix_is_the_same_work(traffic, key):
    # A window holds whole blocks, so each block has to hold every size or
    # defect count of the mix exactly once.
    t = json.loads((TRAFFIC / f"{traffic}.json").read_text())
    items = t[key]
    assert len(items) == t["block"] and t["planned"] % t["block"] == 0
    for seed in (2**31 + 5, 2**31 + 6):
        draws = balanced(seed, items, t["planned"], "x")
        for k in range(0, t["planned"], t["block"]):
            assert sorted(map(str, draws[k:k + t["block"]])) == sorted(map(str, items))


def test_weights_repeat_for_a_seed():
    model = json.loads((CONFIGS / "mistral_7b_v0_3.json").read_text())
    tiny = dict(model["model"], **model["rehearsal"]["model"])
    a, b = make_weights(tiny, 5, "cpu"), make_weights(tiny, 5, "cpu")
    c = make_weights(tiny, 6, "cpu")
    qa = a["text"]["layers_stacked"]["qkv_proj"]["q4"]
    assert torch.equal(qa, b["text"]["layers_stacked"]["qkv_proj"]["q4"])
    assert not torch.equal(qa, c["text"]["layers_stacked"]["qkv_proj"]["q4"])
    assert float(a["text"]["lm_head"]["s"][tiny["eos_token_id"]]) == 0.0


def test_weight_bytes_count_every_leaf_of_a_pass():
    """The bytes a pass must read equal the plan's quantized bytes and
    scales (less the embedding, which a pass reads a row of) plus norms."""
    model = json.loads((CONFIGS / "qwen2_5_vl_7b.json").read_text())["model"]
    assert (model["head_quantization"], model["qkv_bias"]) == ("int4", True)
    plan = _Plan()
    dense_gqa.plan_weights(plan, model)
    bytes_ = sum(_numel(s) for p, s in plan.byte_leaves if "embed_tokens" not in p)
    floats = sum(_numel(s) * (4 if kind == "scale" else 2)
                 for p, s, kind, _ in plan.float_leaves if "embed_tokens" not in p)
    assert abs(dense_gqa.weight_bytes_per_pass(model) - (bytes_ + floats)) < 1e-6 * bytes_


def test_union_overlap_and_gaps_on_a_synthetic_timeline():
    # Kernels (ns): two overlapping, one apart; spans label the host.
    s = np.array([100, 150, 400], np.int64)
    e = np.array([200, 250, 500], np.int64)
    us, ue = timeline.union(s, e)
    assert us.tolist() == [100, 400] and ue.tolist() == [250, 500]
    assert timeline.total(us, ue) == 250
    assert timeline.overlap(us, ue, [0, 450], [180, 1000]) == 80 + 50
    spans = [("decode", 0, 300), ("request", 0, 1000)]
    gaps = dict(map(tuple, timeline.labelled_gaps(us, ue, 0, 600, spans, ("decode", "request"))))
    assert gaps == {"decode": 100 / 1e9, "request": 150 / 1e9 + 100 / 1e9}
    ops = timeline.top_ops(s, e, ["a", "b", "a"])
    assert ops[0] == ["a", 200 / 1e9]


def test_roofline_arithmetic_is_bounded_by_its_own_peak():
    model = json.loads((CONFIGS / "mistral_7b_v0_3.json").read_text())["model"]
    # One pass of one token can take no less than its bytes at peak rate.
    least = dense_gqa.decode_bytes(model, 1, 1000) / work.PEAK_HBM_BYTES
    assert 1.0e-3 < least < 1.2e-3
    assert dense_gqa.decode_flops(model, 1, 1000) / work.PEAK_BF16_FLOPS < least


def _overlap_by_segments(busy_s, busy_e, span_s, span_e):
    """The overlap as the elementary segments between all ends that both
    unions cover (the arithmetic before the running sum)."""
    us, ue = timeline.union(np.asarray(span_s, np.int64), np.asarray(span_e, np.int64))
    pts = np.unique(np.concatenate([busy_s, busy_e, us, ue]))
    left, width = pts[:-1], np.diff(pts)

    def covered(s, e):
        i = np.searchsorted(s, left, side="right") - 1
        return (i >= 0) & (e[np.clip(i, 0, None)] > left)

    return int(width[covered(busy_s, busy_e) & covered(us, ue)].sum())


@pytest.mark.parametrize("seed", range(6))
def test_overlap_equals_the_segment_count(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 3000))
    s = np.sort(rng.integers(0, 10**7, n)).astype(np.int64)
    e = s + rng.integers(0, 20000, n)
    bs, be = timeline.union(s, e)
    m = int(rng.integers(1, 40))
    span_s = rng.integers(-10**5, 10**7 + 10**5, m)
    span_e = span_s + rng.integers(0, 10**6, m)
    got = timeline.overlap(bs, be, span_s, span_e)
    assert got == _overlap_by_segments(bs, be, span_s, span_e)
    lo, hi = 2 * 10**6, 8 * 10**6
    cs, ce = timeline.clip(bs, be, lo, hi)
    assert timeline.overlap(cs, ce, span_s, span_e) == _overlap_by_segments(cs, ce, span_s, span_e)
    assert timeline.overlap(bs, be, [lo], [hi]) == timeline.total(cs, ce)


def test_device_events_reads_only_device_events():
    cuda = torch.autograd.DeviceType.CUDA

    class Event:
        def __init__(self, device, start, dur, name):
            self.device, self.start, self.dur, self.label = device, start, dur, name

        def device_type(self):
            return self.device

        def start_ns(self):
            return self.start

        def duration_ns(self):
            return self.dur

        def name(self):
            return self.label

    events = [Event(cuda, 10, 5, "k1"), Event(torch.autograd.DeviceType.CPU, 0, 99, "op"),
              Event(cuda, 3, 2, "k2")]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    s, e, names = timeline.device_events(prof)
    assert s.dtype == e.dtype == np.int64
    assert s.tolist() == [10, 3] and e.tolist() == [15, 5] and names == ["k1", "k2"]
    prof.profiler.kineto_results.events = lambda: events[1:2]
    s, e, names = timeline.device_events(prof)
    assert len(s) == len(e) == 0 and s.dtype == np.int64 and names == []
