"""The 3D cell ``poisson3d-2refine.ir``: its discovery and seven readers, the
configuration's stated mesh against the benchmark's own build of it, a CPU
rehearsal of its runs at a small size (a sound run correct; the all-float32
control not), and its stamped pass (``benchmark/d3_spans.py``): every new
reader reads its number or nothing, and nothing, without an error, in a CPU
run and in a 2D cell's run."""

import json
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import control, d3_spans, harness, mesh, spans, spec
from pressurepoissonsolver_torch.utils import profiling

from .conftest import corner_mesh, stated

NAME = "poisson3d-2refine.ir"
SPANS_READERS = {"d3.solve.vcycle_ms": "vcycle_ms", "d3.kernels_per_solve": "nodes_per_solve"}
CHAIN_READERS = {f"d3.{key}": key for key in d3_spans.CHAINS}
READERS = ("d3.iterations.ir", *SPANS_READERS, "ghost_stencil_3d_roofline", *CHAIN_READERS)


def _cell(divide=0, n=4):
    cell = spec.find_cell(NAME)
    m = dict(cell.config["mesh"], divide=divide)
    return cell._replace(config=dict(cell.config, **stated(m, n, D=3)))


def _limit():
    return spec.find_cell(NAME).traffic["check"]["residual_limit"]


# -- discovery -----------------------------------------------------------------

def test_the_cell_finds_its_files_and_seven_readers():
    cell = spec.find_cell(NAME)
    assert cell.config["name"] == "poisson3d-2refine" and cell.workload["chips"] == 1
    assert cell.workload["traffic"] == "ir-1e-10" and cell.traffic["entry"] == "solve_refined"
    assert "entry_kwargs" not in cell.config
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    for m in cell.per_layer:
        assert m["moves"] == "dof_per_s" and m["workloads"] == [NAME]
        assert callable(spec.reader("metrics", m["name"]).read)
    assert {m["name"] for m in cell.end_to_end} == {"dof_per_s", "setup_s"}
    # no other cell reports any of them
    for other in ("poisson2d-amr.ir", "poisson2d-amr-d4.ir", "poisson2d-amr-schur.gmg"):
        assert not {m["name"] for m in spec.find_cell(other).per_layer} & set(READERS)


def test_the_configuration_states_its_mesh_and_the_2d_solver():
    cfg = spec.find_cell(NAME).config
    t = mesh.build(cfg["mesh"], 3)
    assert (cfg["patches"], cfg["dof"], cfg["leaf_levels"]) == (7680, 31457280, 2)
    assert (len(t.leaves()), len(t.leaves()) * 16 ** 3, mesh.leaf_levels(t)) == (
        cfg["patches"], cfg["dof"], cfg["leaf_levels"])
    # the reference's fixture: 15 leaves on two levels (17 nodes on 3 levels)
    base = mesh.build(dict(cfg["mesh"], divide=0), 3)
    assert len(base.leaves()) == 15 and len(base.nodes) == 17
    ir = spec.find_cell("poisson2d-amr.ir").config
    assert cfg["solve_options"] == ir["solve_options"] and cfg["cycle"] == ir["cycle"]
    assert (cfg["D"], cfg["n"], cfg["neumann"], cfg["reduced"]) == (3, 16, False, [])
    entry = next(c for c in spec.load_benchmark()["configs"] if c["name"] == cfg["name"])
    assert entry["source"] == cfg["source"] and len(cfg["source"]) <= 200
    assert entry["file"] == "benchmark/configs/poisson3d-2refine.json"


# -- the rehearsal of a run ------------------------------------------------------

def _run(cell, overrides=None):
    return harness.execute(cell, 2 ** 35 + 3, 0.3, False, "cpu", time.perf_counter(), overrides)


def test_a_sound_run_is_correct():
    res = _run(_cell(1))
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"dof_per_s", "setup_s"}
    c = res["compared"]["reference_residual"]
    assert c["value"] <= c["limit"] == _limit()


def test_the_control_is_not_correct():
    res = _run(_cell(1), overrides=control.CONTROL)
    assert not res["correct"]
    assert res["compared"]["reference_residual"]["value"] > 10 * _limit()


# -- the readers -------------------------------------------------------------------

def _span(name, parent, t0, t1, kids=0):
    return profiling.DeviceSpan(name, parent, 0, t0, t1, t1 - t0 - kids)


def test_summary_of_hand_made_device_spans():
    """Two solves; the first a sweep (its trace build beside it) and a
    restriction, the second a trace build: self times summed and divided
    by the solves."""
    sp = [_span(spans.ROOT, -1, 0, 1000, kids=900),
          _span("pps.gmg.L0.smooth", 0, 10, 610, kids=300 + 200),
          _span("pps.traces.plain", 1, 20, 320),
          _span("pps.patch_sweep.plain", 1, 330, 530),
          _span("pps.gmg.L0.restrict", 0, 620, 910, kids=250),
          _span("pps.transfer.plain", 4, 630, 880),
          _span(spans.ROOT, -1, 2000, 2500, kids=100),
          _span("pps.traces.plain", 6, 2100, 2200),
          _span("pps.gmg.L0.smooth", -1, 3000, 3100)]  # outside every solve
    out = d3_spans.summarise(sp, card=True)
    assert out["solves"] == 2
    assert out["traces_ms"] == pytest.approx(400e-6 / 2)
    assert out["sweep_ms"] == pytest.approx(200e-6 / 2)
    assert out["transfer_ms"] == pytest.approx(250e-6 / 2)
    assert out["per_solve"] == {"pps.patch_sweep.plain": 0.5, "pps.traces.plain": 1.0,
                                "pps.transfer.plain": 0.5}
    assert dict(out["spans_ms"])["pps.gmg.L0.smooth"] == pytest.approx(100e-6 / 2)
    # none of the three: nothing to read (a 2D card run, or the parent)
    none = d3_spans.summarise([_span(spans.ROOT, -1, 0, 10)], card=True)
    assert all(none[key] is None for key in d3_spans.CHAINS)
    assert "sweep_ms" not in d3_spans.summarise(sp, card=False)


def test_each_reader_reads_its_number_or_nothing():
    cfg3 = {"D": 3}
    for name, key in SPANS_READERS.items():
        read = spec.reader("metrics", name).read
        assert read(SimpleNamespace(config=cfg3, program_spans={key: 1.5})) == 1.5
        assert read(SimpleNamespace(config=cfg3, program_spans=None)) is None
        assert read(SimpleNamespace(config={"D": 2}, program_spans={key: 1.5})) is None
    for name, key in CHAIN_READERS.items():
        read = spec.reader("metrics", name).read
        assert read(SimpleNamespace(config=cfg3, d3_spans={key: 2.5})) == 2.5
        assert read(SimpleNamespace(config=cfg3, d3_spans=None)) is None
        assert read(SimpleNamespace(config=cfg3, d3_spans={"stamps": {"overflow": 3}})) is None
    it = spec.reader("metrics", "d3.iterations.ir").read
    recs = [harness.Record(0.1, 1e-11, {"iterations": k}) for k in (5.0, 6.0)]
    assert it(SimpleNamespace(config=cfg3, records=recs)) == 5.5
    assert it(SimpleNamespace(config={"D": 2}, records=recs)) is None
    roof = spec.reader("metrics", "ghost_stencil_3d_roofline").read
    assert roof(SimpleNamespace(config=cfg3, device=torch.device("cpu"))) is None
    assert roof(SimpleNamespace(config={"D": 2}, device=torch.device("cuda"))) is None


def _built(cell, seed):
    run = harness.Run(cell, seed, torch.device("cpu"))
    harness.build(run)
    harness.warm_up(run)
    harness.loop(run, count=2)
    return run


def test_the_readers_in_a_cpu_run(capsys):
    """The stamped pass of a traced run, rehearsed on the CPU at a size whose
    V-cycle has levels: every chain's spans decoded under the solves, and no
    device number, so every device reader reads nothing; the iteration
    count is a program counter and reads off the card too."""
    cell = _cell()
    cell = cell._replace(config=dict(cell.config,
                                     cycle=dict(cell.config["cycle"], coarse_direct_max_dof=64)))
    run = _built(cell, 2 ** 35 + 5)
    out = d3_spans.read(run)
    assert out["device"] == "cpu" and out["stamps"]["overflow"] == 0
    assert out["solves"] == int(run.traffic["trace_solves"])
    assert all(v > 0 for v in out["per_solve"].values())
    assert not profiling.device_spans_on()
    line = [x for x in capsys.readouterr().err.splitlines() if x.startswith("d3_spans ")]
    assert json.loads(line[0][len("d3_spans "):]) == out
    got = {name: spec.reader("metrics", name).read(run) for name in READERS}
    assert got.pop("d3.iterations.ir") > 0
    assert got == dict.fromkeys(got)


def test_the_readers_in_a_2d_cells_run():
    cell = spec.find_cell("poisson2d-amr.ir")
    cell = cell._replace(config=dict(cell.config, **stated(corner_mesh(2, 2), 8)))
    run = _built(cell, 2 ** 35 + 7)
    assert {name: spec.reader("metrics", name).read(run) for name in READERS} == dict.fromkeys(
        READERS)
    assert run.d3_spans is None and not hasattr(run, "program_spans")
