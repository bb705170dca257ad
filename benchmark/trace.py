"""The device's busy time, idle gaps and operations from a profiler trace.

The traced run profiles a short window of back-to-back solves with
``torch.profiler`` and exports its Chrome trace.  This module reads that
file: the device's activity is the union of its kernel, memcpy and memset
intervals (annotations projected onto the device are left out); the window
runs from the start of the first of the benchmark's own host spans to the
end of the last.  Each idle gap is named by the innermost host span of the
benchmark that covers its middle.  The per-layer device times read the same
kind of trace of single calls of a layer, one host span around each.
"""

from __future__ import annotations

import bisect
import json
import math
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CAT = "user_annotation"
#: the host's CUDA API calls, which launch the device records
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
#: every host span of the benchmark starts with this
SPAN_PREFIX = "bench/"
#: the caller's loop, and the two spans of one solve inside it: the call
#: and the synchronisation after it
WINDOW_SPAN = "bench/window"
CALL_SPAN = "bench/solver."
SYNC_SPAN = "bench/synchronize"


class TraceSummary(NamedTuple):
    window_s: float
    busy_s: float
    device_records: int
    device_ops: List[Tuple[str, float]]  # the ten longest by total time
    idle_gaps: List[Tuple[str, float]]  # the ten longest gaps, by host span


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarise(events: List[dict]) -> TraceSummary:
    """The summary of a trace's ``traceEvents`` (times in µs)."""
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
             for e in events
             if e.get("ph") == "X" and e.get("cat") == HOST_CAT
             and str(e.get("name", "")).startswith(SPAN_PREFIX)]
    if not spans:
        raise ValueError("the trace holds none of the benchmark's host spans")
    t0 = min(s[0] for s in spans)
    t1 = max(s[1] for s in spans)
    device = []
    per_op: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or str(e.get("cat", "")).lower() not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        device.append((a, b))
        per_op[str(e.get("name", "?"))] += b - a
    busy = _union(device)
    busy_us = sum(b - a for a, b in busy)
    gaps = []
    edge = t0
    for a, b in busy + [(t1, t1)]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    named = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        covering = [s for s in spans if s[0] <= mid <= s[1]]
        name = min(covering, key=lambda s: s[1] - s[0])[2] if covering else "no span"
        named.append((name, (b - a) * 1e-6))
    named.sort(key=lambda x: -x[1])
    ops = sorted(((k, v * 1e-6) for k, v in per_op.items()), key=lambda x: -x[1])
    return TraceSummary((t1 - t0) * 1e-6, busy_us * 1e-6, len(device), ops[:10], named[:10])


def _device(events: List[dict]):
    for e in events:
        if e.get("ph") == "X" and str(e.get("cat", "")).lower() in DEVICE_CATS:
            yield float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))


def _spans(events: List[dict], match) -> List[Tuple[float, float]]:
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") == HOST_CAT
                  and match(str(e.get("name", ""))))


def host_turns(events: List[dict]) -> List[Tuple[str, float]]:
    """The ten longest stretches of the caller's loop between solves: from
    the start of the window, or the end of a solve's synchronisation, to
    the start of the next solve's call.  The device has nothing queued
    then, whether or not the trace recorded every kernel of the solves."""
    window = _spans(events, lambda n: n == WINDOW_SPAN)
    calls = _spans(events, lambda n: n.startswith(CALL_SPAN))
    syncs = _spans(events, lambda n: n == SYNC_SPAN)
    if not window:
        raise ValueError("the trace holds no window span of the benchmark")
    gaps = []
    edge = window[0][0]
    for a, _ in calls:
        if a > edge:
            gaps.append((f"{WINDOW_SPAN} (host turn between solves)", (a - edge) * 1e-6))
        ends = [b for s, b in syncs if s >= a]
        edge = min(ends) if ends else math.inf
    gaps.sort(key=lambda x: -x[1])
    return gaps[:10]


def span_busy(events: List[dict], name: str) -> List[float]:
    """Device seconds of each host span ``name``: the union of the device
    intervals launched inside it (the caller synchronises after each).  A
    device record is placed by the host time of the runtime call that
    launched it (matched by ``correlation``), or by its own start where the
    trace holds no such call."""
    starts = [a for a, _ in _spans(events, lambda n: n == name)]
    if not starts:
        raise ValueError(f"the trace holds no span {name!r}")
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    per: List[List[Tuple[float, float]]] = [[] for _ in starts]
    for e in events:
        if e.get("ph") != "X" or str(e.get("cat", "")).lower() not in DEVICE_CATS:
            continue
        a = float(e["ts"])
        at = launched.get(e.get("args", {}).get("correlation"), a)
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0:
            per[i].append((a, a + float(e.get("dur", 0))))
    return [sum(b - a for a, b in _union(iv)) * 1e-6 for iv in per]


def load(path: str) -> List[dict]:
    """The ``traceEvents`` of an exported Chrome trace."""
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data
