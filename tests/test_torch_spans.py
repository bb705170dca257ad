"""The port's spans on the CPU (``utils.profiling``): ``span`` off and on,
host spans (nesting, parent and solve ids, self time), device stamps in
their buffer format (written with ``perf_counter_ns`` on the CPU, decoded as
on the card), the overflow count, the clock offsets and the device-span
track of ``profiling.trace``, the set-up spans of a solver build, the device
node accounting of ``utils.graphs`` (``launches["nodes"]``) on a program
captured through an emulation of ``graphs.capture``, and a stamped solve
against an unstamped one.  The stamp kernel itself runs only on the card
(``tests/test_torch_cuda.py``)."""

import json

import pytest
import torch

from pressurepoissonsolver_torch.domain import DomainHierarchy
from pressurepoissonsolver_torch.geometry import refined_tree
from pressurepoissonsolver_torch.gmg import CycleOpts
from pressurepoissonsolver_torch.krylov import While
from pressurepoissonsolver_torch.solver import PoissonSolver, SolveOptions
from pressurepoissonsolver_torch.utils import counters, graphs, profiling

GMG = CycleOpts(pre_sweeps=2, post_sweeps=1, fac_smoothing="active", coarse_direct_max_dof=64)


@pytest.fixture(autouse=True)
def spans_off():
    """Every test starts and ends with spans off and no record kept."""
    profiling.disable()
    profiling.clear()
    yield
    profiling.disable()
    profiling.clear()


def _solver():
    h = DomainHierarchy(refined_tree(2, 3, 1), n=8)
    opts = SolveOptions(tol=1e-10, precond_dtype=torch.float32, gmg=GMG)
    s = PoissonSolver(h, opts, device="cpu")
    f = torch.sin(torch.arange(h.finest.num_cells, dtype=torch.float64).reshape(-1, 8, 8)
                  * 0.37)
    return s, f


def test_span_off_is_the_shared_null_context():
    assert profiling.span("pps.test.a") is profiling.span("pps.test.b")
    with profiling.span("pps.test.a"):
        pass
    assert profiling.host_spans() == [] and not profiling.device_spans_on()


def test_host_spans_nest_with_parent_and_solve_ids():
    profiling.enable()
    with profiling.span("pps.test.setup"):
        pass
    for _ in range(2):
        with profiling.span("pps.test.solve", solve=True):
            with profiling.span("pps.test.outer"):
                with profiling.span("pps.test.inner"):
                    torch.ones(4).sum()
    rec = profiling.host_spans()
    assert [r.name for r in rec] == ["pps.test.setup"] + [
        "pps.test.solve", "pps.test.outer", "pps.test.inner"] * 2
    assert [r.parent for r in rec] == [-1, -1, 1, 2, -1, 4, 5]
    assert [r.solve for r in rec] == [-1, 0, 0, 0, 1, 1, 1]
    for r in rec:
        assert r.t0_ns <= r.t1_ns and isinstance(r.bytes, int)
        if r.parent >= 0:
            p = rec[r.parent]
            assert p.t0_ns <= r.t0_ns and r.t1_ns <= p.t1_ns
    profiling.disable()
    with profiling.span("pps.test.after"):
        pass
    assert len(profiling.host_spans()) == 7


def test_host_span_opens_a_record_function_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("pps.test.off"):
            torch.ones(4).sum()
        profiling.enable()
        with profiling.span("pps.test.on"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "pps.test.on" in names and "pps.test.off" not in names


def test_spanned_wraps_each_call():
    @profiling.spanned("pps.test.fn")
    def fn(x):
        """doc"""
        return x + 1

    assert fn(1) == 2 and fn.__name__ == "fn" and fn.__doc__ == "doc"
    profiling.enable()
    fn(2)
    assert [r.name for r in profiling.host_spans()] == ["pps.test.fn"]


def test_device_stamps_on_the_cpu_nest_with_self_time():
    with profiling.device_spans("cpu") as rec:
        assert profiling.device_spans_on()
        for _ in range(2):
            with profiling.span("pps.test.dsolve", solve=True):
                with profiling.span("pps.test.a"):
                    with profiling.span("pps.test.b"):
                        torch.ones(8).sum()
                    with profiling.span("pps.test.host", device=False):
                        pass
                with profiling.span("pps.test.c"):
                    pass
    assert not profiling.device_spans_on()
    assert rec.taken == len(rec.entries) == 16 and rec.overflow == 0
    sp = rec.spans()
    assert [s.name.split(".")[-1] for s in sp] == ["dsolve", "a", "b", "c"] * 2
    assert [s.parent for s in sp] == [-1, 0, 1, 0, -1, 4, 5, 4]
    assert [s.solve for s in sp] == [0, 0, 0, 0, 1, 1, 1, 1]
    for i, s in enumerate(sp):
        kids = [c for c in sp if c.parent == i]
        assert s.self_ns == (s.t1_ns - s.t0_ns) - sum(c.t1_ns - c.t0_ns for c in kids)
        assert s.self_ns >= 0
    assert profiling.host_spans() == []  # stamps alone record no host span


def test_a_buffer_in_the_stamp_format_decodes():
    """Ids are 2 * the name's index, + 1 at the exit; times in ns."""
    rec = profiling.DeviceRecord(torch.device("cpu"))
    a, b = profiling._id("pps.test.fa"), profiling._id("pps.test.fb")
    rec.entries = torch.tensor([[2 * a, 100], [0, 120], [2 * b, 130], [2 * b + 1, 170],
                                [2 * b, 180], [2 * b + 1, 190], [2 * a + 1, 250]]).numpy()
    rec.taken = 7
    sp = rec.spans()
    assert [(s.name, s.parent, s.t0_ns, s.t1_ns, s.self_ns) for s in sp] == [
        ("pps.test.fa", -1, 100, 250, 150 - 40 - 10), ("pps.test.fb", 0, 130, 170, 40),
        ("pps.test.fb", 0, 180, 190, 10)]
    assert rec.clocks() == [120]
    rec.entries = rec.entries[[0, 2, 6]]
    with pytest.raises(ValueError, match="without its entry"):
        rec.spans()


def test_stamps_past_the_capacity_are_counted_and_the_record_refused(monkeypatch):
    monkeypatch.setattr(profiling, "STAMP_CAPACITY", 8)
    monkeypatch.setattr(profiling, "_buffers", {})
    with profiling.device_spans("cpu") as rec:
        for _ in range(10):
            with profiling.span("pps.test.many"):
                pass
    assert rec.taken == 20 and len(rec.entries) == 8 and rec.overflow == 12
    with pytest.raises(ValueError, match="truncated"):
        rec.spans()
    with profiling.device_spans("cpu") as again:  # the cursor starts anew
        with profiling.span("pps.test.many"):
            pass
    assert again.taken == 2 and again.overflow == 0 and len(again.spans()) == 1


def test_clock_offsets_pair_the_clock_stamps_with_their_records():
    rec = profiling.DeviceRecord(torch.device("cuda", 0))
    rec.entries = torch.tensor([[0, 5_000_000], [2 * profiling._id("pps.test.k"), 5_001_000],
                                [2 * profiling._id("pps.test.k") + 1, 5_002_000],
                                [0, 5_010_000]]).numpy()
    rec.clock_ordinals = [7, 8]
    kernel = [{"ph": "X", "cat": "kernel", "name": profiling.CLOCK_KERNEL, "ts": ts, "dur": 1}
              for ts in (3000.0, 3010.002)]
    offsets = rec.clock_offsets(kernel, first=7)
    assert offsets == pytest.approx([2_000_000, 1_999_998])
    assert rec.trace_us(5_000_000, offsets) == pytest.approx(3000.0)
    assert rec.trace_us(5_010_000, offsets) == pytest.approx(3010.002)
    assert rec.trace_us(5_005_000, offsets) == pytest.approx(3005.001)
    assert rec.clock_offsets(kernel[:1], first=7) is None  # a clock record missing
    assert rec.clock_offsets(kernel, first=8) is None


def test_trace_writes_the_device_span_track(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.device_spans("cpu") as rec:
            with profiling.span("pps.test.outer"):
                with profiling.span("pps.test.inner"):
                    torch.ones(64).sum()
    assert len(rec.clock_ordinals) == 2
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    track = {e["name"]: e for e in events if e.get("cat") == "pps_device_span"}
    assert set(track) == {"pps.test.outer", "pps.test.inner"}
    assert all(e["pid"] == profiling.DEVICE_TRACK_PID for e in track.values())
    o, i = track["pps.test.outer"], track["pps.test.inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e-3
    host = {e["name"]: e for e in events
            if e.get("cat") == "user_annotation" and e["name"].startswith("pps.test.")}
    for name, e in track.items():  # on the trace's clock: beside its host span
        assert abs(e["ts"] - host[name]["ts"]) < 2000
    assert any(e.get("ph") == "M" and e.get("pid") == profiling.DEVICE_TRACK_PID
               for e in events)


def test_stamp_resolution_on_the_cpu():
    r = profiling.stamp_resolution_ns("cpu", reads=256)
    assert r["min_step_ns"] > 0 and r["distinct"] > 1 and r["span_ns"] > 0


def test_set_up_spans_split_a_solver_build():
    profiling.enable()
    h = DomainHierarchy(refined_tree(2, 3, 1), n=8)
    s = PoissonSolver(h, SolveOptions(precond_dtype=torch.float32, gmg=GMG), device="cpu")
    rec = profiling.host_spans()
    names = [r.name for r in rec]
    init = names.index("pps.solver.init")
    assert rec[init].parent == -1 and names.index("pps.domain.hierarchy") < init
    levels = [r for r in rec if r.name == "pps.level.build"]
    assert len(levels) == 1 + len(s.gmg.levels)  # the f64 finest, the cycle's f32 levels
    assert all(r.parent == init for r in levels)
    assert sum(r.name == "pps.gmg.transfer" for r in rec) == len(s.gmg.transfers)
    assert names.count("pps.gmg.coarse_inverse") == 1
    assert all(r.solve == -1 for r in rec)


class _Graph:
    """An emulated captured graph: a replay runs ``fn`` again on the same
    static buffers; ``nodes`` stands for the device nodes the card would
    count."""

    made = 0

    def __init__(self, fn):
        self.fn = fn
        _Graph.made += 1
        self.nodes = 2 + _Graph.made
        self.label = "pps.graphs.piece." + graphs._capture_state["label"]

    def replay(self):
        with profiling.span(self.label):
            self.fn()


def _emulated_capture(fn, device):
    fn()
    return _Graph(fn), {}


@pytest.fixture
def emulated(monkeypatch):
    monkeypatch.setattr(graphs, "capture", _emulated_capture)


def _executions(tree, runs, times=1, out=None):
    """Each piece's runs in a run that made ``runs`` passes per loop slot."""
    out = [] if out is None else out
    for item in tree:
        if isinstance(item, graphs._Loop):
            _executions(item.body, runs, int(runs[item.index]), out)
        else:
            out.append((item, times))
    return out


def _guards(tree, runs, times=1):
    n = 0
    for item in tree:
        if isinstance(item, graphs._Loop):
            n += times + int(runs[item.index]) + _guards(item.body, runs, int(runs[item.index]))
    return n


def test_node_accounting_of_an_emulated_program(emulated):
    """Replayed piece by piece, ``launches["nodes"]`` adds each piece's
    nodes per replay; the accounting of a graph launch with the same passes
    adds them times the passes, the guard kernels and the counters' memset."""
    s, f = _solver()
    s._graphs = True
    graphs.reset_launches()
    u, info = s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
    g = s._captured[("refined", "bicgstab")].graphs
    runs = [info["outer_iterations"], info["inner_iterations"]]
    pieces = _executions(g.tree, runs)
    assert len(pieces) == 4 and len(g.whiles) == 2
    replayed = sum(p.nodes * t for p, t in pieces)
    assert graphs.launches["nodes"] == replayed > 0
    graphs.reset_launches()
    g.account(runs)
    assert graphs.launches["nodes"] == replayed + _guards(g.tree, runs) + 1
    assert graphs.launches["guard"] == _guards(g.tree, runs)


@pytest.mark.parametrize("mode", [False, True])
def test_a_stamped_solve_is_bitwise_the_unstamped_one(emulated, mode):
    """Eager (``_graphs`` False) and through the emulated capture, where the
    stamped graph has its own key and the pieces are spans of their own
    (after the solve that captures it: a capture's warm-up runs eagerly)."""
    s, f = _solver()
    s._graphs = mode
    u0, i0 = s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
    with profiling.device_spans("cpu"):  # captures: its warm-up calls stamp too
        s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
    with profiling.device_spans("cpu") as rec:
        u1, i1 = s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
    u2, _ = s.solve_refined(f, tol=1e-10, inner_tol=1e-4)
    assert torch.equal(u0, u1) and torch.equal(u0, u2)
    assert i0["inner_iterations"] == i1["inner_iterations"] == 7
    sp = rec.spans()
    names = [x.name for x in sp]
    assert names[0] == "pps.solver.solve_refined" and {x.solve for x in sp} == {0}
    assert names.count("pps.krylov.operator") == 2 * i1["inner_iterations"]
    assert names.count("pps.gmg.vcycle") == 2 * i1["inner_iterations"]
    if mode:
        assert sorted(s._captured) == [("refined", "bicgstab"),
                                       ("refined", "bicgstab", "stamped")]
        assert names.count("pps.solver.round_end") == i1["outer_iterations"]
        pieces = [x for x in sp if x.name.startswith("pps.graphs.piece.")]
        assert all(x.parent == 0 for x in pieces)
        assert {x.name for x in pieces} == {f"pps.graphs.piece.{n}"
                                            for n in ("init", "begin", "step", "end")}
        vcyc = [x for x in sp if x.name == "pps.gmg.vcycle"]
        assert all(sp[sp[x.parent].parent].name == "pps.graphs.piece.step" for x in vcyc)
    else:
        assert s._captured == {}


def test_a_while_body_of_pieces_is_counted_per_pass(emulated):
    """A toy program (an init, a loop of two pieces): the nodes of a launch
    that made ``n`` passes are init + n * (both pieces) + the guards + 1."""
    from typing import NamedTuple

    class St(NamedTuple):
        x: torch.Tensor
        k: torch.Tensor
        go: torch.Tensor

    def init(b):
        return St(b.clone(), torch.zeros((), dtype=torch.int64), torch.ones((), dtype=bool))

    def half(s):
        return s._replace(x=s.x / 2)

    def count(s):
        k = s.k + 1
        return s._replace(k=k, go=k < 3)

    b = torch.ones(4)
    g = graphs.GraphLoop((b,), init, (While(lambda s: s.go, (half, count)),),
                         lambda: init(b), count, torch.device("cpu"))
    graphs.reset_launches()
    runs = g.replay()
    assert runs == [3] and torch.equal(g.state.x, torch.full((4,), 0.125))
    init_p, half_p, count_p = g.tree[0], *g.tree[1].body
    assert graphs.launches["nodes"] == init_p.nodes + 3 * (half_p.nodes + count_p.nodes)
    graphs.reset_launches()
    g.account(runs)
    assert graphs.launches["nodes"] == (init_p.nodes + 3 * (half_p.nodes + count_p.nodes)
                                        + (1 + 3) + 1)


def _schur(s, f):
    return s.solve_schur(f, tol=1e-10, max_iter=60, preconditioner="gmg")


def _ancestors(sp, i):
    out = []
    while sp[i].parent >= 0:
        i = sp[i].parent
        out.append(sp[i].name)
    return out


@pytest.mark.parametrize("mode", [False, True])
def test_a_stamped_schur_solve_nests_its_spans(emulated, mode):
    """An interface solve's spans, eager and through the emulated capture:
    one ``pps.solver.solve_schur`` a solve at the root, its two ends once,
    and per iteration two operator applies (each ``pps.level.schur_S``
    over one ``pps.level.patch_solve`` and one ``pps.level.interpolate``)
    and two Woodbury preconditioner applies (each one V-cycle and one
    interpolation); the answer bitwise the unstamped one's."""
    s, f = _solver()
    s._graphs = mode
    u0, r0 = _schur(s, f)
    with profiling.device_spans("cpu"):  # captures the stamped graph
        _schur(s, f)
    with profiling.device_spans("cpu") as rec:
        u1, r1 = _schur(s, f)
    assert torch.equal(u0, u1) and r0.iterations == r1.iterations > 0
    k = r1.iterations
    sp = rec.spans()
    names = [x.name for x in sp]
    assert names[0] == "pps.solver.solve_schur" and names.count(names[0]) == 1
    assert {x.solve for x in sp} == {0}
    assert names.count("pps.solver.schur_rhs") == names.count("pps.solver.schur_recover") == 1
    for name in ("pps.krylov.operator", "pps.level.schur_S", "pps.krylov.precond",
                 "pps.gmg.vcycle"):
        assert names.count(name) == 2 * k, name
    assert names.count("pps.level.patch_solve") == 2 * k + 2
    assert names.count("pps.level.interpolate") == 4 * k + 1
    for i, x in enumerate(sp):
        if x.name == "pps.level.schur_S":
            up = _ancestors(sp, i)
            assert up[0] == "pps.krylov.operator" and up[-1] == "pps.solver.solve_schur"
            kids = [y.name for y in sp if y.parent == i]
            assert kids == ["pps.level.patch_solve", "pps.level.interpolate"]
        if x.name == "pps.gmg.vcycle":
            assert _ancestors(sp, i)[0] == "pps.krylov.precond"
    if mode:
        assert sorted(s._captured) == [("schur", "gmg"), ("schur", "gmg", "stamped")]
        pieces = {x.name for x in sp if x.name.startswith("pps.graphs.piece.")}
        assert pieces == {f"pps.graphs.piece.{n}" for n in ("init", "step", "recover")}
        rhs = names.index("pps.solver.schur_rhs")
        assert sp[sp[rhs].parent].name == "pps.graphs.piece.init"
    else:
        assert s._captured == {}


@pytest.mark.parametrize("mode", [False, True])
def test_the_patch_solve_counter_counts_each_pass(emulated, mode):
    """``level_ops.solved``: an interface solve of ``k`` iterations makes
    ``2k + 2`` patch-solve passes (two operator applies an iteration, the
    right-hand side and the recovery), each over every patch; the counter
    zeroes, and a read is a copy."""
    from pressurepoissonsolver_torch.ops import level_ops

    s, f = _solver()
    s._graphs = mode
    _schur(s, f)  # captures, where it does
    counters.reset()
    assert level_ops.patch_solves() == {"passes": 0, "patches": 0}
    _, r = _schur(s, f)
    got = level_ops.patch_solves()
    assert got["passes"] == 2 * r.iterations + 2
    assert got["patches"] == got["passes"] * s.fine_level.P
    got["passes"] = -1
    assert level_ops.solved["passes"] == 2 * r.iterations + 2
    counters.reset()
    assert level_ops.solved == {"passes": 0, "patches": 0}


def test_the_patch_solve_counter_is_in_the_launch_accounting():
    """The counter is one of the tables a captured piece accounts for
    (``utils.counters``, by name), so a graph launch adds a piece's patch
    solves times its passes."""
    from pressurepoissonsolver_torch.ops import level_ops

    assert counters.table("level_ops.patch_solves", ("passes", "patches")) is level_ops.solved
    counters.reset()
    assert "level_ops.patch_solves" in counters.snapshot()
    counters.add({"level_ops.patch_solves": {"passes": 1, "patches": 19}}, 3)
    assert level_ops.patch_solves() == {"passes": 3, "patches": 57}
    counters.reset()


def test_schur_spans_off_record_nothing():
    """With spans off an interface solve records no span and no stamp."""
    s, f = _solver()
    _schur(s, f)
    assert profiling.host_spans() == [] and not profiling.device_spans_on()
