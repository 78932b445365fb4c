"""Device time from a profiler trace: busy intervals, operations by name,
and idle gaps labelled by what the host was doing.

Each device event (kernel, copy, set) counts once: the busy time is the
length of the union of their intervals, so operations that overlap are
not added twice.  Timestamps are the profiler's, on the Unix clock in ns,
the clock ``Recorder`` spans use.  Arrays are numpy int64 ns, so a trace
of millions of kernels reduces in seconds.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

import numpy as np


def device_events(prof) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """(starts, ends, names) of every device event of a stopped
    ``torch.profiler.profile``, read from the raw results without building
    the profiler's own event tree."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.profiler.kineto_results.events() if e.device_type() == cuda]
    if not events:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), []
    kind, n = type(events[0]), len(events)
    s = np.fromiter(map(kind.start_ns, events), np.int64, n)
    return s, s + np.fromiter(map(kind.duration_ns, events), np.int64, n), \
        list(map(kind.name, events))


def union(starts: np.ndarray, ends: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Merged intervals (sorted, disjoint) of [starts, ends)."""
    if len(starts) == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.nonzero(new)[0]
    last = np.append(first[1:] - 1, len(s) - 1)
    return s[first], reach[last]


def clip(starts, ends, lo: int, hi: int):
    keep = (ends > lo) & (starts < hi)
    return np.maximum(starts[keep], lo), np.minimum(ends[keep], hi)


def total(starts, ends) -> int:
    return int((ends - starts).sum())


def overlap(busy_s, busy_e, span_s, span_e) -> int:
    """ns of the busy union (sorted and disjoint, as ``union`` gives it)
    inside the union of the spans: at each span's ends, the busy time
    before it from a running sum of the busy intervals."""
    us, ue = union(np.asarray(span_s, np.int64), np.asarray(span_e, np.int64))
    if len(us) == 0 or len(busy_s) == 0:
        return 0
    done = np.concatenate([[0], np.cumsum(busy_e - busy_s)])

    def busy_before(t):
        k = np.searchsorted(busy_s, t, side="right")  # intervals begun by t
        last = np.clip(k - 1, 0, None)
        return np.where(k > 0, done[last] + np.minimum(t, busy_e[last]) - busy_s[last], 0)

    return int((busy_before(ue) - busy_before(us)).sum())


def top_ops(starts, ends, names: Sequence[str], n: int = 10) -> List[list]:
    by_name: Dict[str, int] = collections.Counter()
    for name, d in zip(names, (ends - starts).tolist()):
        by_name[name] += d
    return [[name, ns / 1e9] for name, ns in by_name.most_common(n)]


def labelled_gaps(busy_s, busy_e, lo: int, hi: int,
                  spans: Sequence[Tuple[str, int, int]], priority: Sequence[str],
                  n: int = 10) -> List[list]:
    """Idle time inside [lo, hi], summed by the host span around each
    gap's midpoint, the first of ``priority`` that holds it ("host" where
    none does)."""
    bs, be = clip(busy_s, busy_e, lo, hi)
    gap_s = np.concatenate([[lo], be])
    gap_e = np.concatenate([bs, [hi]])
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    mids = (gap_s + gap_e) // 2
    labels = np.full(len(mids), -1)
    for k, name in enumerate(priority):
        kind = [(a, b) for nm, a, b in spans if nm == name]
        if not kind:
            continue
        us, ue = union(np.array([a for a, _ in kind], np.int64),
                       np.array([b for _, b in kind], np.int64))
        idx = np.searchsorted(us, mids, side="right") - 1
        inside = (idx >= 0) & (mids < ue[np.clip(idx, 0, None)])
        labels[(labels < 0) & inside] = k
    by_label: Dict[str, int] = collections.Counter()
    for k, d in zip(labels.tolist(), (gap_e - gap_s).tolist()):
        by_label[priority[k] if k >= 0 else "host"] += d
    return [[name, ns / 1e9] for name, ns in by_label.most_common(n)]


__all__ = ["device_events", "union", "clip", "total", "overlap", "top_ops", "labelled_gaps"]
