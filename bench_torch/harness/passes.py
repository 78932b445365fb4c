"""The program's own span records of a traced window, read by the
``decode.*_per_pass`` metrics.

While a torch profiler records, the program (``vis_tpu_torch.utils.logger``)
keeps one record per span: ``decode.pass`` for each weight pass of its
decode loops (a lookahead window, or one step of a token-a-pass loop),
``sync`` for each blocking host<->device transfer, and the spans that hold
them, each with its ``parent`` span's id, its ``thread``, and ``start_ns`` /
``end_ns`` on the Unix clock of the profiler's device events.  The decode
spans are the records that are parents of ``decode.pass`` records
(``engine.decode``, ``scheduler.decode``, a loop engine's
``<prefix>.decode``).  A decode region is a decode span, or the
``scheduler.chunk`` span that holds it with the transfers that set the
chunk up.  A region that another thread's ``engine.prefill`` overlaps is
left out, with its passes: the prefill's kernels and its hold on the
interpreter are not the decode's.  A program that keeps no records gives
None, and so does a window without a pass left.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

CHUNK = "scheduler.chunk"
PREFILL = "engine.prefill"


class DecodeRecords:
    """The window's decode regions, their passes and the syncs inside them.

    ``records`` are the window's; ``prefills`` the ``engine.prefill``
    records that may overlap it (a prefill that began before the window
    counts too)."""

    def __init__(self, records: List[Dict[str, Any]], prefills: List[Dict[str, Any]]):
        by_id = {r["id"]: r for r in records}
        passes = [r for r in records if r["name"] == "decode.pass" and r["parent"] in by_id]
        regions = {}  # decode span id -> its region
        for span_id in {r["parent"] for r in passes}:
            span = by_id[span_id]
            parent = by_id.get(span["parent"])
            regions[span_id] = parent if parent is not None and parent["name"] == CHUNK else span

        def crossed(region):
            return any(p["thread"] != region["thread"] and p["start_ns"] < region["end_ns"]
                       and region["start_ns"] < p["end_ns"] for p in prefills)

        kept = {i: r for i, r in regions.items() if not crossed(r)}
        self.passes_left_out = sum(1 for r in passes if r["parent"] not in kept)
        self.passes = [r for r in passes if r["parent"] in kept]
        self.regions = sorted({r["id"]: r for r in kept.values()}.values(),
                              key=lambda r: r["start_ns"])
        region_ids = {r["id"] for r in self.regions}

        def in_region(r):
            while r is not None:
                if r["id"] in region_ids:
                    return True
                r = by_id.get(r["parent"])
            return False

        self.syncs = [r for r in records if r["name"] == "sync" and in_region(r)]
        pass_ids = {r["id"] for r in self.passes}
        self.pass_syncs = [r for r in self.syncs if r["parent"] in pass_ids]

    def region_bounds(self):
        """(starts, ends) of the decode regions, numpy int64 ns."""
        return (np.array([r["start_ns"] for r in self.regions], np.int64),
                np.array([r["end_ns"] for r in self.regions], np.int64))


def decode_records(run) -> Optional[DecodeRecords]:
    """The decode records wholly inside the traced window, or None where
    the run was not traced, the program keeps no records, or no pass ran
    outside another thread's prefill."""
    if run.trace is None:
        return None
    try:
        from vis_tpu_torch.utils.logger import get_trace
    except ImportError:
        return None
    lo, hi = run.trace.lo, run.trace.hi
    everything = get_trace()
    records = [r for r in everything if r["start_ns"] >= lo and r["end_ns"] <= hi]
    prefills = [r for r in everything if r["name"] == PREFILL
                and r["start_ns"] < hi and r["end_ns"] > lo]
    found = DecodeRecords(records, prefills)
    return found if found.passes else None


__all__ = ["DecodeRecords", "decode_records"]
