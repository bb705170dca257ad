"""Discovery of cells, configurations, traffic mixes and metrics from their
files, and ``BENCHMARK.json`` against the limits of its contract."""

import json
import re
import shutil

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_cell_finds_its_files():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["entry"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.end_to_end:
            assert callable(spec.reader("end_to_end", m["name"]).read)
        for m in cell.per_layer:
            assert callable(spec.reader("metrics", m["name"]).read)


def test_benchmark_json_keeps_to_its_contract():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    # the full check of 24 cells fits its time
    assert 2 + 14 * 24 * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
        for e in bench[group]:
            assert set(e) - {"workloads"} == want, e["name"]
            assert NAME.match(e["name"])
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(cells)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
    for c in bench["configs"]:
        with open(spec.ROOT / c["file"]) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    assert len(json.dumps(bench)) <= 64 * 1024


def test_a_mix_may_name_another_entry_point(tmp_path):
    """A later cell (the Schur solve) is added by files and entries only."""
    shutil.copytree(spec.HERE, tmp_path / "benchmark")
    bench = spec.load_benchmark()
    bench["workloads"].append({"name": "poisson2d-amr.schur", "config": "poisson2d-amr",
                               "traffic": "schur-gmg-1e-10", "chips": 1, "why": "Schur"})
    bench["per_layer"].append({"name": "iterations.schur", "unit": "count",
                               "better": "lower", "source": "program_counter",
                               "layer": "solver.PoissonSolver.solve_schur",
                               "moves": "dof_per_s", "workloads": ["poisson2d-amr.schur"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((spec.HERE / "traffic" / "ir-1e-10.json").read_text())
    traffic.update(entry="solve_schur",
                   kwargs={"tol": 1e-10, "max_iter": 60, "preconditioner": "gmg"},
                   result={"residual": ["residual_norm", "r0_norm"],
                           "counts": {"iterations": "iterations"}})
    (tmp_path / "benchmark" / "traffic" / "schur-gmg-1e-10.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark" / "metrics" / "iterations.schur.py").write_text(
        "def read(run):\n    return 5.0\n")
    cell = spec.find_cell("poisson2d-amr.schur", root=tmp_path)
    assert cell.traffic["entry"] == "solve_schur"
    assert [m["name"] for m in cell.per_layer
            if m["name"] == "iterations.schur"] == ["iterations.schur"]
    assert spec.reader("metrics", "iterations.schur", root=tmp_path).read(None) == 5.0
    # the cells already there are found as before
    assert spec.find_cell("poisson2d-amr.ir", root=tmp_path).traffic["entry"] == "solve_refined"


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.find_cell("no-such-cell")
