"""The program's plain-chain spans inside the one-launch solve, for the
per-layer readers of the 3D cell (``d3.sweep_ms``, ``d3.traces_ms``,
``d3.transfer_ms``).

A 3D level has no sweep, trace or transfer kernel: its block-Jacobi sweeps,
its trace builds and its grid transfers run the plain chains, each in a
span of its own (``pps.patch_sweep.plain``, ``pps.traces.plain``,
``pps.transfer.plain``).  In a traced run the first of these readers to ask
runs one more stamped pass over the same solver and right-hand sides
(:func:`read`, kept on the run):

1. one solve under ``utils.profiling.device_spans``, which captures the
   solve's graph with stamps (its own graph, already there where the pass
   of ``benchmark/spans.py`` ran first);
2. ``trace_solves`` stamped one-launch solves, untraced, from which it reads
   the device self time of every span inside the solves
   (``pps.solver.solve_refined`` and everything nested in it), per solve.

The summary goes to standard error as one line ``d3_spans {...}``: the self
ms a solve of each of the three spans and how many of each a solve opens,
and the ten spans with the most self time a solve.  A 2D cell's run, a
program without the stamps, and one that opens none of these spans (before
they existed; a 2D level on a card, which runs the kernels) read nothing
(``None``).  Off the card the pass runs with the CPU's stamps, so that the
path is rehearsed, and gives the counts but no device number.
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from typing import Optional

import torch

from . import spans

#: reader key -> the program's span
CHAINS = {"sweep_ms": "pps.patch_sweep.plain", "traces_ms": "pps.traces.plain",
          "transfer_ms": "pps.transfer.plain"}


def read(run) -> Optional[dict]:
    """The pass's summary (computed at the first call, kept on ``run``), or
    ``None`` where there is nothing to read."""
    if not hasattr(run, "d3_spans"):
        run.d3_spans = measure(run)
        if run.d3_spans is not None:
            print("d3_spans " + json.dumps(run.d3_spans), file=sys.stderr, flush=True)
    return run.d3_spans


def measure(run) -> Optional[dict]:
    if int(run.config["D"]) != 3:
        return None
    found = spans._program()
    if found is None or not hasattr(run, "solver"):
        return None
    _, profiling = found
    n = int(run.traffic["trace_solves"])
    dev = run.device
    card = dev.type == "cuda"
    # the right-hand sides of the benchmark's traced solves (harness.profile)
    problems = [(run.next - n + i) % len(run.pool) for i in range(n)]
    out: dict = {"device": torch.cuda.get_device_name(dev) if card else "cpu"}
    with profiling.device_spans(dev):  # captures the stamped graph
        spans._one(run, problems[0])
    with profiling.device_spans(dev) as rec:
        for j in problems:
            spans._one(run, j)
    out["stamps"] = {"taken": rec.taken, "capacity": rec.capacity, "overflow": rec.overflow}
    if rec.overflow:
        return out
    out.update(summarise(rec.spans(), card))
    return out


def summarise(sp: list, card: bool) -> dict:
    """The readers' numbers from the decoded device spans ``sp`` of the
    stamped solves (``card``: device numbers; else only the counts)."""
    solves = [i for i, x in enumerate(sp) if x.parent == -1 and x.name == spans.ROOT]
    inside = set(solves)
    for i, x in enumerate(sp):
        if x.parent in inside:
            inside.add(i)
    self_ns = defaultdict(int)
    opened = defaultdict(int)
    for i in inside:
        x = sp[i]
        if x.name != spans.ROOT:
            self_ns[x.name] += x.self_ns
            opened[x.name] += 1
    k = max(len(solves), 1)
    out: dict = {"solves": len(solves),
                 "per_solve": {name: opened[name] / k for name in CHAINS.values()}}
    if card:
        for key, name in CHAINS.items():
            out[key] = 1e-6 * self_ns[name] / k if opened[name] else None
        top = sorted(self_ns.items(), key=lambda kv: -kv[1])[:10]
        out["spans_ms"] = [[name, 1e-6 * ns / k] for name, ns in top]
    return out
