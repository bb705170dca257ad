"""The program's spans and counters inside a one-launch interface solve, for
the per-layer readers of the Schur cell (``schur.operator_ms``,
``schur.precond_ms``, ``schur.kernels_per_solve``).

The pass of ``benchmark/spans.py``, rooted at the span
``pps.solver.solve_schur`` in place of ``pps.solver.solve_refined``, and
reusing its solve and its look for the program's counter and stamps.  In a
traced run the first of these readers to ask runs one more pass over the
same solver and right-hand sides (:func:`read`, kept on the run):

1. ``trace_solves`` one-launch solves, untraced, across which the program's
   counters give the device nodes per solve (``utils.graphs.launches
   ["nodes"]``) and the patch-solve passes and patches per solve
   (``ops.level_ops.patch_solves()``);
2. one solve under ``utils.profiling.device_spans``, which captures the
   solve's graph again with stamps (its own graph: the timed one holds none);
3. ``trace_solves`` stamped one-launch solves, untraced, from which it reads
   each span's device duration and self time inside the solves, and the gaps
   between the graph's pieces;
4. ``2 * trace_solves`` solves in turns, unstamped and stamped: what the
   stamps cost a solve.

The summary goes to standard error as one line ``schur_spans {...}``.  A
program without the counter reads nothing here (``None``); one without the
root span gives no span number, and its readers leave their metrics out.
Off the card the pass runs with the CPU's stamps and gives no device
number.
"""

from __future__ import annotations

import importlib
import json
import statistics
import sys
from collections import defaultdict
from typing import Optional

import torch

from . import spans

ROOT = "pps.solver.solve_schur"
OPERATOR = "pps.level.schur_S"
PRECOND = "pps.krylov.precond"


def read(run) -> Optional[dict]:
    """The pass's summary (computed at the first call, kept on ``run``), or
    ``None`` where the program has nothing to read."""
    if not hasattr(run, "schur_spans"):
        run.schur_spans = measure(run)
        if run.schur_spans is not None:
            print("schur_spans " + json.dumps(run.schur_spans), file=sys.stderr, flush=True)
    return run.schur_spans


def _patch_solves():
    """The program's patch-solve counter, or None where it has none."""
    level_ops = importlib.import_module("pressurepoissonsolver_torch.ops.level_ops")
    return getattr(level_ops, "patch_solves", None)


def measure(run) -> Optional[dict]:
    found = spans._program()
    if found is None or not hasattr(run, "solver"):
        return None
    graphs, profiling = found
    from pressurepoissonsolver_torch.ops import ghost_stencil

    n = int(run.traffic["trace_solves"])
    dev = run.device
    card = dev.type == "cuda"
    one_launch = card and getattr(run.solver, "_graphs", None) is True
    problems = [(run.next - n + i) % len(run.pool) for i in range(n)]
    out: dict = {"device": torch.cuda.get_device_name(dev) if card else "cpu"}

    counted = _patch_solves()
    ghost_stencil.counters()
    before = graphs.launches["nodes"]
    solved = counted() if counted else None
    for j in problems:
        spans._one(run, j)
    ghost_stencil.counters()
    out["nodes_per_solve"] = (graphs.launches["nodes"] - before) / n if one_launch else None
    if counted:
        after = counted()
        out["patch_solves_per_solve"] = {k: (after[k] - solved[k]) / n for k in after}

    with profiling.device_spans(dev):  # captures the stamped graph
        spans._one(run, problems[0])
    with profiling.device_spans(dev) as rec:
        for j in problems:
            spans._one(run, j)
    plain, stamped = [], []
    for i in range(2 * n):
        plain.append(spans._one(run, problems[i % n]))
        with profiling.device_spans(dev):
            stamped.append(spans._one(run, problems[i % n]))
    out["wall_ms"] = {"unstamped": 1e3 * statistics.median(plain),
                      "stamped": 1e3 * statistics.median(stamped)}
    out["stamps"] = {"taken": rec.taken, "capacity": rec.capacity, "overflow": rec.overflow}
    if rec.overflow:
        return out
    out.update(summarise(rec.spans(), card))
    return out


def summarise(sp: list, card: bool) -> dict:
    """The readers' numbers from the decoded device spans ``sp`` of the
    stamped solves (``card``: device numbers; else only the counts and the
    closure, which checks the decoding)."""
    solves = [i for i, x in enumerate(sp) if x.parent == -1 and x.name == ROOT]
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
    span_ns = 0
    gaps = defaultdict(float)
    for s in solves:
        pieces = [x for x in sp if x.parent == s and x.name.startswith(spans.PIECE)]
        if not pieces:
            continue
        span_ns += pieces[-1].t1_ns - pieces[0].t0_ns
        for a, b in zip(pieces, pieces[1:]):
            gaps[f"{spans._label(a.name)} -> {spans._label(b.name)}"] += (b.t0_ns - a.t1_ns) * 1e-9
    gap_s = sum(gaps.values())

    def mean_ms(name):
        d = durations.get(name)
        return 1e-6 * sum(d) / len(d) if d else None

    out: dict = {"solves": len(solves),
                 "counts": {k: len(durations.get(k, [])) for k in (OPERATOR, PRECOND,
                                                                    "pps.level.patch_solve")}}
    if card:
        out["operator_ms"] = mean_ms(OPERATOR)
        out["precond_ms"] = mean_ms(PRECOND)
        out["krylov_operator_ms"] = mean_ms("pps.krylov.operator")
        out["rhs_ms"] = mean_ms("pps.solver.schur_rhs")
        out["recover_ms"] = mean_ms("pps.solver.schur_recover")
        out["graph_gap_pct"] = 100.0 * 1e9 * gap_s / span_ns if span_ns > 0 else None
        out["solve_span_ms"] = 1e-6 * span_ns / max(len(solves), 1)
        out["spans"] = [[k, v] for k, v in sorted(self_s.items(), key=lambda kv: -kv[1])[:12]]
        out["graph_gaps"] = dict(sorted(gaps.items(), key=lambda kv: -kv[1])[:8])
    inner_self_s = 1e-9 * sum(sp[i].self_ns for i in inside if sp[i].name != ROOT)
    out["closure"] = (inner_self_s + gap_s) / (1e-9 * span_ns) if span_ns > 0 else None
    return out
