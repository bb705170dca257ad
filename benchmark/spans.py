"""The program's own spans and graph-node counter, for the per-layer readers
that read them (``solve.vcycle_ms``, ``solve.operator_ms``,
``solve.graph_gap_pct``, ``kernels_per_solve``).

In a traced run, after the benchmark's own traces and the other readers, the
first of these readers to ask runs one more pass over the same solver and
right-hand sides (:func:`read`, kept on the run):

1. ``trace_solves`` one-launch solves, untraced, across which the program's
   counter of device nodes (``utils.graphs.launches["nodes"]``: each piece's
   kernel, memcpy and memset nodes times its passes, the guard kernels and
   the memset of the pass counters) gives the nodes per solve;
2. one solve under ``utils.profiling.device_spans``, which captures the
   solve's graph again with stamp kernels at the edges of every span
   (its own graph: the timed one holds no stamp);
3. ``trace_solves`` stamped one-launch solves, untraced, from which it
   reads each span's device duration and self time inside the solves (the
   stamps of ``pps.solver.solve_refined`` and everything nested in it) and
   the gaps between the graph's pieces (``pps.graphs.piece.*``: the WHILE
   guards and the child-graph transitions);
4. ``2 * trace_solves`` solves in turns, unstamped and stamped, on the same
   right-hand side in each pair: what the stamps cost a solve;
5. ``trace_solves`` stamped solves under ``torch.profiler`` with host spans
   on, the clock stamps taken at both ends, from which it reads, through
   the clock offsets, the host's launch call to the first stamp and the last
   stamp to the host's return.  Its device numbers are not the metrics': on
   the card the profiler slows a one-launch solve that holds stamps (PERF.md).

Every solve takes the right-hand sides of the benchmark's traced solves.  The
summary goes to standard error as one line ``spans {...}``.

A program without the counter or the stamps reads nothing here (``None``):
every reader then leaves its metric out.  Off the card the pass runs with the
CPU's stamps, so that the path is rehearsed, and gives no device number.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from typing import Optional

import torch

from . import harness
from . import trace as trace_mod

ROOT = "pps.solver.solve_refined"
PIECE = "pps.graphs.piece."
LAUNCH = "pps.graphs.launch"
#: the most the clock offsets at the two ends of the profiled pass may
#: differ for host and device times to be set against each other (they
#: differ by 1-14 µs in most runs; by ms where a clock record is amiss)
MAX_DRIFT_S = 50e-6


def read(run) -> Optional[dict]:
    """The pass's summary (computed at the first call, kept on ``run``), or
    ``None`` where the program has nothing to read."""
    if not hasattr(run, "program_spans"):
        run.program_spans = measure(run)
        if run.program_spans is not None:
            print("spans " + json.dumps(run.program_spans), file=sys.stderr, flush=True)
    return run.program_spans


def _program():
    from pressurepoissonsolver_torch.utils import graphs, profiling

    if "nodes" not in graphs.launches or not hasattr(profiling, "device_spans"):
        return None
    return graphs, profiling


def _one(run, j: int) -> float:
    """One solve of the pool's ``j``-th right-hand side; its wall (s)."""
    t0 = time.perf_counter()
    run.call(run.pool[j])
    harness._sync(run.device)
    return time.perf_counter() - t0


def measure(run) -> Optional[dict]:
    found = _program()
    if found is None or not hasattr(run, "solver"):
        return None
    graphs, profiling = found
    from pressurepoissonsolver_torch.ops import ghost_stencil

    n = int(run.traffic["trace_solves"])
    dev = run.device
    card = dev.type == "cuda"
    one_launch = card and getattr(run.solver, "_graphs", None) is True
    # the right-hand sides of the benchmark's traced solves (harness.profile)
    problems = [(run.next - n + i) % len(run.pool) for i in range(n)]
    out: dict = {"device": torch.cuda.get_device_name(dev) if card else "cpu"}

    ghost_stencil.counters()  # the accounting of any solve not yet read
    before = graphs.launches["nodes"]
    for j in problems:
        _one(run, j)
    ghost_stencil.counters()
    out["nodes_per_solve"] = (graphs.launches["nodes"] - before) / n if one_launch else None

    with profiling.device_spans(dev):  # captures the stamped graph
        _one(run, problems[0])
    with profiling.device_spans(dev) as rec:
        for j in problems:
            _one(run, j)
    plain, stamped = [], []
    for i in range(2 * n):
        plain.append(_one(run, problems[i % n]))
        with profiling.device_spans(dev):
            stamped.append(_one(run, problems[i % n]))
    out["wall_ms"] = {"unstamped": 1e3 * statistics.median(plain),
                      "stamped": 1e3 * statistics.median(stamped)}
    out["stamps"] = {"taken": rec.taken, "capacity": rec.capacity, "overflow": rec.overflow}
    if rec.overflow:
        return out
    sp = rec.spans()
    out.update(summarise(sp, card))
    out["stamps"]["per_solve"] = rec.taken / max(len(_edges(sp)[0]), 1)

    events, traced = _traced(run, problems, profiling)
    if card and not traced.overflow:
        tsp = traced.spans()
        _, firsts, lasts, span_ns, _ = _edges(tsp)
        out["graph_gaps"].update(_host_gaps(traced, events, firsts, lasts))
        out["traced_solve_span_ms"] = 1e-6 * span_ns / max(len(firsts), 1)
    return out


def _traced(run, problems: list, profiling):
    """The stamped solves of ``problems`` under ``torch.profiler``, host
    spans on: the trace's events and the device record."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.device.type == "cuda"
                                     else [])
    tmp = tempfile.mkdtemp(prefix="bench-spans-")
    host = profiling._state.host
    profiling.enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with profiling.device_spans(run.device) as rec:
                for j in problems:
                    _one(run, j)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = trace_mod.load(path)
    finally:
        if not host:
            profiling.disable()
        profiling.clear()
        shutil.rmtree(tmp, ignore_errors=True)
    return events, rec


def _label(name: str) -> str:
    return name[len(PIECE):]


def _edges(sp: list):
    """Per solve (a ``pps.solver.solve_refined`` device span) its pieces:
    ``(solves, first stamps, last stamps, summed device span in ns, gaps
    between consecutive pieces in s by "before -> after" label)``."""
    solves = [i for i, x in enumerate(sp) if x.parent == -1 and x.name == ROOT]
    firsts, lasts, span_ns = [], [], 0
    gaps = defaultdict(float)
    for s in solves:
        pieces = [x for x in sp if x.parent == s and x.name.startswith(PIECE)]
        if not pieces:
            continue
        firsts.append(pieces[0].t0_ns)
        lasts.append(pieces[-1].t1_ns)
        span_ns += pieces[-1].t1_ns - pieces[0].t0_ns
        for a, b in zip(pieces, pieces[1:]):
            gaps[f"{_label(a.name)} -> {_label(b.name)}"] += (b.t0_ns - a.t1_ns) * 1e-9
    return solves, firsts, lasts, span_ns, gaps


def summarise(sp: list, card: bool) -> dict:
    """The readers' numbers from the decoded device spans ``sp`` of the
    stamped solves (``card``: device numbers; else only the path's own
    checks)."""
    solves, firsts, _, span_ns, gaps = _edges(sp)
    inside = set(solves)
    for i, x in enumerate(sp):
        if x.parent in inside:
            inside.add(i)
    durations = defaultdict(list)
    self_s = defaultdict(float)
    for i in inside:
        x = sp[i]
        durations[x.name].append(x.t1_ns - x.t0_ns)
        if x.name != ROOT:
            self_s[x.name] += x.self_ns * 1e-9
    gap_s = sum(gaps.values())
    out: dict = {}

    def mean_ms(name):
        d = durations.get(name)
        return 1e-6 * sum(d) / len(d) if d else None

    if card:
        out["vcycle_ms"] = mean_ms("pps.gmg.vcycle")
        out["operator_ms"] = mean_ms("pps.krylov.operator")
        out["graph_gap_pct"] = 100.0 * 1e9 * gap_s / span_ns if span_ns > 0 else None
        out["spans"] = [[k, v] for k, v in sorted(self_s.items(), key=lambda kv: -kv[1])[:10]]
        out["graph_gaps"] = dict(sorted(gaps.items(), key=lambda kv: -kv[1]))
        out["solve_span_ms"] = 1e-6 * span_ns / max(len(firsts), 1)
    # the self times of the spans inside the solves and the gaps between the
    # pieces against the solves' device spans, first stamp to last: 1 where
    # the pieces tile each solve and every span nests in its parent
    inner_self_s = 1e-9 * sum(sp[i].self_ns for i in inside if sp[i].name != ROOT)
    out["closure"] = (inner_self_s + gap_s) / (1e-9 * span_ns) if span_ns > 0 else None
    out["vcycles"] = len(durations.get("pps.gmg.vcycle", []))
    return out


def _host_gaps(rec, events: list, firsts: list, lasts: list) -> dict:
    """``launch`` (the host's launch call to the first stamp) and ``return``
    (the last stamp to the host's return from the solve), summed over the
    solves in seconds, through the clock offsets; the offsets' drift, and
    only that where it exceeds :data:`MAX_DRIFT_S`."""
    offsets = rec.clock_offsets(events)
    if offsets is None or not firsts:
        return {}

    def host(name):
        return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in events
                      if e.get("ph") == "X" and e.get("cat") == trace_mod.HOST_CAT
                      and e.get("name") == name)

    launches, roots = host(LAUNCH), host(ROOT)
    out = {"clock_drift_s": 1e-9 * (offsets[-1] - offsets[0])}
    if abs(out["clock_drift_s"]) > MAX_DRIFT_S:
        return out  # the clock stamps do not agree: no time is placed through them
    if len(launches) == len(firsts):
        out["launch"] = 1e-6 * sum(rec.trace_us(t, offsets) - a
                                   for t, (a, _) in zip(firsts, launches))
    if len(roots) == len(lasts):
        out["return"] = 1e-6 * sum(b - rec.trace_us(t, offsets)
                                   for t, (_, b) in zip(lasts, roots))
    return {k: v for k, v in out.items() if math.isfinite(v)}
