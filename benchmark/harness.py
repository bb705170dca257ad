"""One run of one cell: set-up, the measured window, the traced window, the
per-layer readers and the comparison with the plain reference.

The program is ``pressurepoissonsolver_torch``, reached through its library
API: the configuration's tree is handed to it as a mesh file
(``geometry.Tree.from_file``), then ``domain.DomainHierarchy`` and
``solver.PoissonSolver`` are built, and the traffic mix's entry point (a
method of the solver) is called on each right-hand side of a seeded pool,
one caller in a closed loop: each solve starts when the previous one has
returned, synchronised.
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, NamedTuple, Optional

import torch

from . import mesh, rhs, spec
from . import trace as trace_mod
from .reference.composite import CompositeOperator, relative_residual

DTYPES = {"float32": torch.float32, "float64": torch.float64}
#: top-level modules that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "pressurepoissonsolver_tpu")


class Record(NamedTuple):
    """One solve of a window."""
    wall_s: float
    residual: float  # the solve's own relative residual
    counts: dict  # the counts it returned (traffic ``result.counts``)
    end_s: float = math.nan  # its return, in seconds from the window's start


class Run:
    """What a run built and measured; the metric readers read it."""

    def __init__(self, cell: spec.Cell, seed: int, device: torch.device):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.device = device
        self.setup: dict = {}
        self.records: List[Record] = []
        self.failed: List[bool] = []
        self.window_s = math.nan
        self.trace: Optional[trace_mod.TraceSummary] = None
        self.sample: list = []  # (pool index, u) drawn from the seed
        self.next = 0  # the pool index of the next solve

    @property
    def D(self) -> int:
        return int(self.config["D"])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def solve_options(config: dict, overrides: Optional[dict] = None):
    """The configuration's ``SolveOptions`` (``overrides``: keys of
    ``solve_options`` replaced, for the control)."""
    from pressurepoissonsolver_torch.gmg import CycleOpts
    from pressurepoissonsolver_torch.solver import SolveOptions

    so = dict(config["solve_options"], **(overrides or {}))
    for key in ("dtype", "precond_dtype"):
        so[key] = DTYPES[so[key]]
    return SolveOptions(gmg=CycleOpts(**config["cycle"]), **so)


def _field(obj, key: str):
    return obj[key] if isinstance(obj, dict) else getattr(obj, key)


def read_result(traffic: dict, out):
    """``(u, residual, counts)`` of an entry point's return ``(u, info)``,
    as the traffic's ``result`` names them: ``residual`` a key (or
    attribute) of ``info``, or ``[numerator, denominator]``."""
    u, info = out
    spec_ = traffic["result"]
    res = spec_["residual"]
    if isinstance(res, str):
        residual = float(_field(info, res))
    else:
        residual = float(_field(info, res[0])) / float(_field(info, res[1]))
    counts = {k: float(_field(info, v)) for k, v in spec_.get("counts", {}).items()}
    return u, residual, counts


def build(run: Run, overrides: Optional[dict] = None) -> None:
    """Mesh, hierarchy, solver and the right-hand-side pool, each timed on
    the host clock, synchronised."""
    from pressurepoissonsolver_torch.domain import DomainHierarchy
    from pressurepoissonsolver_torch.geometry import Tree
    from pressurepoissonsolver_torch.solver import PoissonSolver

    cfg, dev = run.config, run.device
    tree = mesh.build(cfg["mesh"], run.D)
    run.starts, run.lengths = mesh.leaf_boxes(tree)
    run.n = int(cfg["n"])
    run.dof = len(run.starts) * run.n ** run.D
    stated = {"patches": len(run.starts), "dof": run.dof, "leaf_levels": mesh.leaf_levels(tree)}
    for key, built in stated.items():
        if int(cfg[key]) != built:
            raise ValueError(f"the configuration states {key} {cfg[key]}; its mesh has {built}")
    tmp = tempfile.mkdtemp(prefix="bench-mesh-")
    try:
        path = os.path.join(tmp, "mesh.bin")
        mesh.write_mesh(tree, path)
        ptree = Tree.from_file(path, run.D)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    run.hierarchy = DomainHierarchy(ptree, n=run.n, neumann=bool(cfg.get("neumann", False)))
    t1 = time.perf_counter()
    run.solver = PoissonSolver(run.hierarchy, solve_options(cfg, overrides), device=dev)
    _sync(dev)
    t2 = time.perf_counter()
    run.setup["hierarchy_s"] = t1 - t0
    run.setup["solver_s"] = t2 - t1
    if run.hierarchy.finest.num_cells != run.dof:
        raise RuntimeError("the program's finest level does not hold the generated mesh")
    make_inputs(run)
    entry = run.traffic["entry"]
    fn = getattr(run.solver, entry)
    kwargs = dict(run.traffic.get("kwargs", {}))
    kwargs.update(cfg.get("entry_kwargs", {}).get(entry, {}))
    run.entry = entry
    run.call: Callable = lambda f: fn(f, **kwargs)


def make_inputs(run: Run, problem_seed=None) -> None:
    """The right-hand-side pool of ``run.seed`` on the device: the
    traffic's problems, or with ``problem_seed`` those of that seed."""
    r = run.traffic["rhs"]
    if r.get("family") != "modes":
        raise ValueError(f"unknown right-hand-side family {r.get('family')!r}")
    fixed = int(r["problem_seed"]) if problem_seed is None else int(problem_seed)
    run.problems = rhs.draw_pool(run.seed, run.D, int(r["pool"]), int(r["modes"]),
                                 int(r["kmax"]), fixed, r["scales"])
    run.pool = rhs.make_pool(run.starts, run.lengths, run.n, run.problems, run.device,
                             DTYPES[run.config["solve_options"]["dtype"]])
    _sync(run.device)


def warm_up(run: Run) -> None:
    """The first solve (which captures the program's graphs), then the
    traffic's ``warmup`` solves, each on the next right-hand side."""
    t0 = time.perf_counter()
    _solve(run)
    run.setup["first_solve_s"] = time.perf_counter() - t0
    for _ in range(int(run.traffic.get("warmup", 0))):
        _solve(run)


def _solve(run: Run):
    f = run.pool[run.next % len(run.pool)]
    run.next += 1
    out = run.call(f)
    _sync(run.device)
    return out


def loop(run: Run, seconds: Optional[float] = None, count: Optional[int] = None,
         spans: bool = False, keep: bool = True) -> float:
    """A closed loop of one caller, for ``seconds`` (the first solve that
    ends past them is the last) or ``count`` solves; returns its seconds.
    With ``keep`` the solves are recorded and a sample of their answers,
    drawn from the seed, is kept for the comparison."""
    span = torch.profiler.record_function if spans else (lambda _: contextlib.nullcontext())
    label = f"bench/solver.PoissonSolver.{run.entry}"
    dev = run.device
    stop_tol = float(run.traffic["stop_tol"])
    k = int(run.traffic["check"]["sample"])
    rng = rhs.rng_for(run.seed, 2)
    finite = []
    done = 0
    start = time.perf_counter()
    deadline = start + (seconds if seconds is not None else math.inf)
    with span("bench/window"):
        while True:
            j = run.next % len(run.pool)
            run.next += 1
            t0 = time.perf_counter()
            with span(label):
                out = run.call(run.pool[j])
            with span("bench/synchronize"):
                _sync(dev)
            t1 = time.perf_counter()
            done += 1
            if keep:
                u, residual, counts = read_result(run.traffic, out)
                finite.append(torch.isfinite(u).all())
                run.records.append(Record(t1 - t0, residual, counts, t1 - start))
                i = len(run.records) - 1
                if i < k:
                    run.sample.append((j, u))
                else:
                    slot = int(rng.integers(0, i + 1))
                    if slot < k:
                        run.sample[slot] = (j, u)
            if t1 >= deadline or (count is not None and done >= count):
                break
    window_s = t1 - start
    if keep:
        ok = torch.stack(finite).cpu().tolist()
        run.failed = [not (r.residual <= stop_tol) or not fin
                      for r, fin in zip(run.records, ok)]
    return window_s


def _traced(run: Run, solves: int):
    """``solves`` back-to-back solves under ``torch.profiler``: the summary
    of the trace and its events (written under ``TMPDIR`` and read back)."""
    from torch.profiler import ProfilerActivity

    tmp = tempfile.mkdtemp(prefix="bench-trace-")
    try:
        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loop(run, count=solves, spans=True, keep=False)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = trace_mod.load(path)
        return trace_mod.summarise(events), events
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def profile(run: Run, solves: int) -> trace_mod.TraceSummary:
    """The traced window: ``solves`` back-to-back solves on the timed path,
    each a single graph launch.

    The profiler records no kernel that runs inside the WHILE nodes of a
    one-launch solve (on the card its trace holds about a fifth of them).
    So the same solves are traced a second time through the same captured
    pieces replayed one by one (the solver's per-step replay,
    ``_graphs = "steps"``), in which every kernel is recorded.  The summary
    is a hybrid of the two traces, over the same right-hand sides: the
    device's busy time and operations from the replay, the window and the
    idle gaps from the one-launch trace.  Its only idle gaps that are sure
    to be idle are the host's turns between solves (the device has nothing
    queued then), so those are the gaps it reports.  Raises where the solver
    does not run one launch a solve: there is no other source."""
    if run.device.type != "cuda":
        raise RuntimeError("the traced window needs a CUDA card; it has no CPU fallback")
    if getattr(run.solver, "_graphs", None) is not True:
        raise RuntimeError("the solver does not run one graph launch a solve "
                           "(solver._graphs is not True): no traced window")
    first = run.next
    one, one_events = _traced(run, solves)
    run.next = first
    run.solver._graphs = "steps"
    try:
        steps, _ = _traced(run, solves)
    finally:
        run.solver._graphs = True
    run.trace_one_launch = one
    return steps._replace(window_s=one.window_s, idle_gaps=trace_mod.host_turns(one_events))


def compare(run: Run) -> dict:
    """The numbers compared, each with its limit: the largest relative
    residual ``||f - A u|| / ||f||`` of the sampled answers under the plain
    reference's operator, and the failed solves."""
    op = CompositeOperator(run.starts, run.lengths, run.n, device=run.device)
    worst = max((relative_residual(op, u, run.pool[j]) for j, u in run.sample),
                default=math.inf)
    if not math.isfinite(worst):
        worst = math.inf
    check = run.traffic["check"]
    return {"reference_residual": {"value": worst, "limit": float(check["residual_limit"])},
            "failed_solves": {"value": sum(run.failed), "limit": 0}}


def free_program(run: Run) -> None:
    """Drop the program's objects, so that the reference runs on a card
    the program no longer holds."""
    for name in ("solver", "hierarchy", "call"):
        if hasattr(run, name):
            delattr(run, name)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def read_metrics(run: Run, kind: str, metrics: List[dict]) -> dict:
    out = {}
    for m in metrics:
        value = spec.reader(kind, m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """The forbidden top-level modules loaded in this process."""
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def power_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0].split(",")[-1].strip() if out.stdout else ""


def window_summary(run: Run) -> dict:
    """Quartiles and extremes of the window's walls (ms), their median in
    each 5 s of the window (``median_ms_by_5s``, by the solve's return) and
    the mean of each returned count: what the end-to-end numbers rest on."""
    walls = sorted(1e3 * r.wall_s for r in run.records)
    out = {"solves": len(walls), "seconds": run.window_s}
    if len(walls) >= 2:
        q1, q2, q3 = statistics.quantiles(walls, n=4)
        out.update(min_ms=walls[0], q1_ms=q1, median_ms=q2, q3_ms=q3, max_ms=walls[-1])
    bins: dict = {}
    for r in run.records:
        if math.isfinite(r.end_s):
            bins.setdefault(int(r.end_s // 5), []).append(1e3 * r.wall_s)
    if bins:
        out["median_ms_by_5s"] = [round(statistics.median(bins[b]), 3) if b in bins else None
                                  for b in range(max(bins) + 1)]
    for key in run.traffic["result"].get("counts", {}):
        vals = [r.counts[key] for r in run.records]
        out[f"{key}_mean"] = sum(vals) / len(vals) if vals else None
    return out


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
            t_start: float, overrides: Optional[dict] = None) -> dict:
    """One run of ``cell`` (``t_start``: ``perf_counter()`` at the process's
    start); returns the result line's object."""
    device = torch.device(device)
    run = Run(cell, seed, device)
    build(run, overrides)
    warm_up(run)
    run.setup["setup_s"] = time.perf_counter() - t_start
    run.window_s = loop(run, seconds=seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if traced:
        run.trace = profile(run, int(cell.traffic["trace_solves"]))
        metrics = read_metrics(run, "metrics", cell.per_layer)
    else:
        metrics = read_metrics(run, "end_to_end", cell.end_to_end)
    free_program(run)
    compared = compare(run)
    correct = (all(c["value"] <= c["limit"] for c in compared.values())
               and bool(run.sample))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell.workload.get("chips", 1)),
           "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    result = {"correct": correct, "attempted": len(run.records), "failed": sum(run.failed),
              "metrics": metrics, "device": dev, "window": window_summary(run)}
    if run.trace is not None:
        t = run.trace
        dev["busy_s"] = t.busy_s
        dev["window_s"] = t.window_s
        dev["device_records"] = t.device_records
        one = getattr(run, "trace_one_launch", None)
        if one is not None:
            dev["one_launch"] = {"busy_s": one.busy_s, "device_records": one.device_records}
        result["breakdown"] = {"device_ops": [list(x) for x in t.device_ops],
                               "idle_gaps": [list(x) for x in t.idle_gaps]}
    result["compared"] = compared
    return result
