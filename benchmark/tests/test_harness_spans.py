"""The readers of the program's spans and node counter
(``benchmark/spans.py``): on a synthetic run, on hand-made device spans, on
a program that has neither, and the extra traced pass rehearsed on the CPU,
which reads no device number and must not raise."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spans, spec
from pressurepoissonsolver_torch.utils import graphs, profiling

READERS = {"solve.vcycle_ms": "vcycle_ms", "solve.operator_ms": "operator_ms",
           "solve.graph_gap_pct": "graph_gap_pct", "kernels_per_solve": "nodes_per_solve"}


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_reads_its_number_or_nothing(name):
    read = spec.reader("metrics", name).read
    assert read(SimpleNamespace(program_spans={READERS[name]: 1.5})) == 1.5
    assert read(SimpleNamespace(program_spans=None)) is None
    # a truncated record: the pass left its numbers out
    assert read(SimpleNamespace(program_spans={"stamps": {"overflow": 3}})) is None


def _span(name, parent, t0, t1, kids=0):
    return profiling.DeviceSpan(name, parent, 0, t0, t1, t1 - t0 - kids)


def test_summary_of_hand_made_device_spans():
    """Two solves, each two pieces with a gap of 10 ns between them; a
    V-cycle and an operator apply inside the second piece."""
    sp = []
    for base in (0, 1000):
        root = len(sp)
        sp.append(_span(spans.ROOT, -1, base, base + 500, kids=100 + 200))
        sp.append(_span("pps.graphs.piece.init", root, base + 50, base + 150))
        step = len(sp)
        sp.append(_span("pps.graphs.piece.step", root, base + 160, base + 360, kids=120))
        sp.append(_span("pps.gmg.vcycle", step, base + 170, base + 250))
        sp.append(_span("pps.krylov.operator", step, base + 260, base + 300))
    out = spans.summarise(sp, card=True)
    assert out["vcycle_ms"] == pytest.approx(80e-6)
    assert out["operator_ms"] == pytest.approx(40e-6)
    assert out["graph_gap_pct"] == pytest.approx(100 * 20 / 620)
    assert out["graph_gaps"] == {"init -> step": pytest.approx(20e-9)}
    assert out["closure"] == pytest.approx(1.0)
    assert out["spans"][0] == ["pps.graphs.piece.init", pytest.approx(200e-9)]
    assert out["solve_span_ms"] == pytest.approx(310e-6)
    cpu = spans.summarise(sp, card=False)
    assert "vcycle_ms" not in cpu and cpu["vcycles"] == 2


def test_a_program_without_the_counter_reads_nothing(monkeypatch):
    monkeypatch.setattr(graphs, "launches", {"guard": 0, "passes": 0, "graph": 0})
    run = SimpleNamespace(solver=object())
    assert spans.read(run) is None and run.program_spans is None
    for name in READERS:
        assert spec.reader("metrics", name).read(run) is None


def test_the_extra_pass_rehearsed_on_the_cpu(cell):
    """The pass of a traced run on the CPU: the CPU's stamps are decoded
    (every V-cycle of the traced solves), and no device number is read."""
    run = harness.Run(cell, 2 ** 35 + 5, torch.device("cpu"))
    harness.build(run)
    harness.warm_up(run)
    out = spans.read(run)
    assert out["device"] == "cpu" and out["nodes_per_solve"] is None
    assert out["stamps"]["overflow"] == 0 and out["stamps"]["taken"] > 0
    assert out["vcycles"] > 0 and "vcycle_ms" not in out
    assert not profiling.device_spans_on() and profiling.host_spans() == []
    for name in READERS:
        assert spec.reader("metrics", name).read(run) is None
