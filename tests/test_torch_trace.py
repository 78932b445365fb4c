"""The port's span records (``vis_tpu_torch.utils.logger``), kept only
while a torch profiler records, and the benchmark's four readers of them.

The port side runs in one subprocess (torch_port_runner.py ``trace``) on
the tiny text profile: schema requests in lookahead windows (greedy and
sampled) with no profiler and under a CPU profiler, beside the
benchmark's own pass count (its ``Recorder``); a chat turn; three
requests through the paged scheduler.  Pinned here:

- with no profiler no record is kept, and ``get_timings()`` holds the
  names and counts it held before records existed, with a profiler too;
- one ``decode.pass`` record per weight pass, as many as the benchmark
  counts (lookahead windows; the scheduler's ``stats["steps"]``), each
  under its decode span; a scheduler chunk's decode span inside its
  ``scheduler.chunk`` span with the chunk's input transfer;
- the ``sync`` records of a lookahead window: the blocking transfers the
  decode loop makes; no ``decode.replay`` record on the CPU, and on the
  card's path (a stand-in graph whose replay runs the pass eagerly) one
  inside every window of a request but its first (the warm-up);
- children inside their parents, all records inside ``time.time_ns()``
  readings taken around the calls (the profiler's clock), and so from 16
  threads at once; a span closed in another thread leaves its own
  thread's stack; ``get_trace(reset=True)`` drops what it returns;
- a chat turn's decode in an ``engine.decode`` span, its seconds and
  tokens both counted by the engine;
- each ``decode.*`` reader on a hand-built timeline, which leaves out a
  chunk that another thread's prefill overlaps; the replayed share at 0
  where nothing replays, and silent for a program without the graph.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from torch_port import run_port

ROOT = Path(__file__).resolve().parents[1]
SETTINGS = dict(max_cache_tokens=1024, decode_chunk=8, lookahead=8, device_preprocess=False,
                min_json_tokens=0)
# A lookahead window's blocking transfers (models/common/decoder.py): its
# tokens' .cpu().  The window's pass reads no host value, and a sampled
# call sends its temperature once, before its first window.
SYNCS_PER_WINDOW = {"greedy": 1, "sampled": 1}
CHAT_TOKENS = 20


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = run_port("trace", {"settings": np.array(json.dumps(SETTINGS))},
                   tmp_path_factory.mktemp("torch_trace"))
    return json.loads(str(out["out"]))


def _within(records, window):
    lo, hi = window
    return [r for r in records if lo <= r["start_ns"] and r["end_ns"] <= hi]


def _children(records, parent, name):
    return [r for r in records if r["parent"] == parent["id"] and r["name"] == name]


def test_no_profiler_keeps_no_record(port):
    assert port["off"] == {"records": 0, "timings": {"engine.prefill": 1, "engine.decode": 1}}
    # Under the profiler the timings keep their names: no pass or sync entry.
    assert port["on_timings"] == {"engine.prefill": 3, "engine.decode": 3}


@pytest.mark.parametrize("mode", sorted(SYNCS_PER_WINDOW))
def test_lookahead_passes_equal_the_benchmarks_count(port, mode):
    records = _within(port["records"], port["times"][mode])
    (decode,) = [r for r in records if r["name"] == "engine.decode"]
    passes = [r for r in records if r["name"] == "decode.pass"]
    assert len(passes) == port["passes"][mode] > 0
    assert all(r["parent"] == decode["id"] for r in passes)
    # One thread serves the request: its prefill and decode share it.
    assert {r["thread"] for r in records} == {decode["thread"]}


@pytest.mark.parametrize("mode", sorted(SYNCS_PER_WINDOW))
def test_sync_records_per_window(port, mode):
    records = _within(port["records"], port["times"][mode])
    passes = [r for r in records if r["name"] == "decode.pass"]
    counts = {len(_children(records, p, "sync")) for p in passes}
    assert counts == {SYNCS_PER_WINDOW[mode]}


@pytest.mark.parametrize("mode", sorted(SYNCS_PER_WINDOW))
def test_replay_records_under_their_pass(port, mode):
    # On the CPU every window runs eagerly: no replay.
    records = _within(port["records"], port["times"][mode])
    assert not [r for r in records if r["name"] == "decode.replay"]
    # The card's path with a stand-in graph: the request's first window
    # warms its pass up, every later one replays, inside its pass.
    records = _within(port["records"], port["times"][f"replayed_{mode}"])
    by_id = {r["id"]: r for r in records}
    passes = sorted((r for r in records if r["name"] == "decode.pass"),
                    key=lambda r: r["start_ns"])
    replays = [r for r in records if r["name"] == "decode.replay"]
    assert all(by_id[r["parent"]]["name"] == "decode.pass" for r in replays)
    assert len(passes) > 1
    assert sorted(r["parent"] for r in replays) == sorted(p["id"] for p in passes[1:])
    # With no profiler nothing is recorded (test_no_profiler_keeps_no_record).
    assert port["off"]["records"] == 0


def test_scheduler_passes_equal_its_steps(port):
    from bench_torch.harness.passes import DecodeRecords

    records = _within(port["records"], port["times"]["scheduler"])
    by_id = {r["id"]: r for r in records}
    decodes = [r for r in records if r["name"] == "scheduler.decode"]
    passes = [r for r in records if r["name"] == "decode.pass"]
    assert len(passes) == port["steps"] > 0
    assert {r["parent"] for r in passes} <= {c["id"] for c in decodes}
    # Each decode span lies in its chunk's span beside the chunk's input
    # transfer (greedy rows: no temperature copy).
    for d in decodes:
        chunk = by_id[d["parent"]]
        assert chunk["name"] == "scheduler.chunk"
        assert len(_children(records, chunk, "sync")) == 1
    # The readers see every pass, in a chunk or left out with a chunk that
    # a request's prefill (in its caller's thread) overlapped.
    prefills = [r for r in records if r["name"] == "engine.prefill"]
    assert len(prefills) == 3
    found = DecodeRecords(records, prefills)
    assert len(found.passes) + found.passes_left_out == port["steps"]


def test_records_nest_on_the_callers_clock(port):
    records = port["records"]
    by_id = {r["id"]: r for r in records}
    windows = [port["times"]["profiled"], port["times"]["replayed"], port["times"]["scheduler"],
               port["stress"]["window"], port["handed"]["window"]]
    for r in records:
        assert r["start_ns"] <= r["end_ns"]
        assert any(lo <= r["start_ns"] and r["end_ns"] <= hi for lo, hi in windows), r
        parent = by_id.get(r["parent"])
        if r["parent"] is not None:
            assert parent is not None and parent["thread"] == r["thread"]
            assert parent["start_ns"] <= r["start_ns"] and r["end_ns"] <= parent["end_ns"]


def test_records_from_many_threads(port):
    """Spans nested in 16 threads switching every microsecond: every record
    kept once, under a distinct id, each child under its own thread's
    enclosing span."""
    stress = port["stress"]
    assert stress["alive"] == 0
    assert stress["records"] == stress["ids"] == stress["expected"]
    assert stress["astray"] == 0


def test_span_closed_in_another_thread(port):
    handed = port["handed"]
    assert handed["held_thread"] == handed["after_thread"] == handed["here"]
    assert handed["after_parent"] is None
    assert port["after_reset"] == 0


def test_chat_turn_counts_its_decode(port):
    chat = port["chat"]
    assert chat["tokens"] == chat["last"] == CHAT_TOKENS
    assert 0 < chat["seconds"] <= chat["wall"]
    records = _within(port["records"], port["times"]["chat"])
    (decode,) = [r for r in records if r["name"] == "engine.decode"]
    assert len(_children(records, decode, "decode.pass")) == CHAT_TOKENS


# A hand-built window [0, 1 ms].  Thread 1: an engine.decode span [100,
# 700] us with two passes (the second replayed) and a sync of its own,
# inside an ``inspector`` span that also holds a sync outside it.  Thread 2: a scheduler.chunk
# [580, 900] holding its input transfer and a scheduler.decode with one
# pass; a second chunk [920, 990] that thread 3's prefill overlaps (left
# out, its pass too); a chunk past the window.
US = 1000


def _rec(name, rid, parent, thread, start_us, end_us):
    return {"name": name, "id": rid, "parent": parent, "thread": thread,
            "start_ns": start_us * US, "end_ns": end_us * US}


RECORDS = [
    _rec("inspector", 1, None, 1, 0, 900),
    _rec("engine.decode", 2, 1, 1, 100, 700),
    _rec("decode.pass", 3, 2, 1, 100, 300),
    _rec("sync", 4, 3, 1, 250, 300),
    _rec("decode.pass", 5, 2, 1, 300, 500),
    _rec("sync", 6, 5, 1, 400, 480),
    _rec("sync", 7, 2, 1, 500, 520),
    _rec("sync", 8, 1, 1, 800, 810),
    _rec("scheduler.chunk", 14, None, 2, 580, 900),
    _rec("sync", 15, 14, 2, 580, 590),
    _rec("scheduler.decode", 9, 14, 2, 600, 900),
    _rec("decode.pass", 10, 9, 2, 650, 850),
    _rec("sync", 11, 10, 2, 700, 750),
    _rec("scheduler.chunk", 16, None, 2, 920, 990),
    _rec("scheduler.decode", 17, 16, 2, 930, 990),
    _rec("decode.pass", 18, 17, 2, 930, 980),
    _rec("sync", 20, 17, 2, 980, 990),
    _rec("engine.prefill", 19, None, 3, 940, 960),
    _rec("scheduler.chunk", 21, None, 2, 1100, 1200),
    _rec("scheduler.decode", 12, 21, 2, 1100, 1200),
    _rec("decode.pass", 13, 12, 2, 1100, 1150),
    _rec("decode.replay", 22, 5, 1, 310, 490),
    _rec("decode.replay", 23, 18, 2, 935, 975),
    _rec("decode.replay", 24, 13, 2, 1105, 1145),
]
EVENTS = [(50, 90), (150, 260), (320, 330), (585, 590), (600, 720), (880, 950), (950, 960),
          (1100, 1110)]
# Passes 3, 5, 10.  Host: (200 - 50) + (200 - 80) + (200 - 50) us.  Syncs
# in the regions: 4, 6, 7, 15, 11.  Events starting in [100, 900] us:
# 150, 320, 585, 600, 880.  Busy inside [100, 900]: 110 + 10 + 5 + 120 + 20
# of 800 us.  Replays under those passes: 22 (23's pass is left out, 24's
# past the window).
EXPECTED = {
    "decode.replayed_share": 100 / 3,
    "decode.host_ms_per_pass": 0.420 / 3,
    "decode.syncs_per_pass": 5 / 3,
    "decode.device_ops_per_pass": 5 / 3,
    "decode.idle_ms_per_pass": 0.535 / 3,
}


def _synthetic_run():
    from bench_torch.harness import timeline

    ev_s = np.array([a * US for a, _ in EVENTS], np.int64)
    ev_e = np.array([b * US for _, b in EVENTS], np.int64)
    lo, hi = 0, 1000 * US
    busy_s, busy_e = timeline.clip(*timeline.union(ev_s, ev_e), lo, hi)
    return SimpleNamespace(trace=SimpleNamespace(lo=lo, hi=hi, ev_s=ev_s, ev_e=ev_e,
                                                 busy_s=busy_s, busy_e=busy_e))


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_a_hand_built_timeline(metric, monkeypatch):
    import vis_tpu_torch.utils.logger as program_logger
    from bench_torch.harness.spec import BENCH_DIR, load_module

    reader = load_module(BENCH_DIR / "metrics" / f"{metric}.py", f"bench_metric_{metric}")
    run = _synthetic_run()
    monkeypatch.setattr(program_logger, "get_trace", lambda: [dict(r) for r in RECORDS])
    assert reader.read(run) == pytest.approx(EXPECTED[metric], rel=1e-12)
    # No traced window, or a window without a pass: nothing to read.
    assert reader.read(SimpleNamespace(trace=None)) is None
    monkeypatch.setattr(program_logger, "get_trace", lambda: RECORDS[:2])
    assert reader.read(run) is None


def _replayed_share_reader():
    from bench_torch.harness.spec import BENCH_DIR, load_module

    return load_module(BENCH_DIR / "metrics" / "decode.replayed_share.py",
                       "bench_metric_decode.replayed_share")


def test_replayed_share_is_silent_without_replays(monkeypatch):
    """A program with no replayed window pass (no ``WindowPass`` in its
    decoder, as before the graph) gives no reading, though its passes
    are recorded."""
    import vis_tpu_torch.models.common.decoder as program_decoder
    import vis_tpu_torch.utils.logger as program_logger

    monkeypatch.setattr(program_logger, "get_trace", lambda: [
        dict(r) for r in RECORDS if r["name"] != "decode.replay"])
    monkeypatch.delattr(program_decoder, "WindowPass")
    assert _replayed_share_reader().read(_synthetic_run()) is None


def test_replayed_share_reads_zero_when_nothing_replays(monkeypatch):
    """A program that has the window pass but whose passes never replay
    (a lost capture, a pass rebuilt every window) reads 0, not nothing."""
    import vis_tpu_torch.utils.logger as program_logger

    monkeypatch.setattr(program_logger, "get_trace", lambda: [
        dict(r) for r in RECORDS if r["name"] != "decode.replay"])
    assert _replayed_share_reader().read(_synthetic_run()) == 0.0


def test_regions_leave_out_a_chunk_under_anothers_prefill():
    from bench_torch.harness.passes import DecodeRecords

    window = [r for r in RECORDS if r["end_ns"] <= 1000 * US]
    found = DecodeRecords(window, [r for r in window if r["name"] == "engine.prefill"])
    assert [r["id"] for r in found.regions] == [2, 14]
    assert [r["id"] for r in found.passes] == [3, 5, 10]
    assert found.passes_left_out == 1
    # With no prefill beside it, the second chunk counts.
    found = DecodeRecords(window, [])
    assert [r["id"] for r in found.regions] == [2, 14, 16]
    assert found.passes_left_out == 0
