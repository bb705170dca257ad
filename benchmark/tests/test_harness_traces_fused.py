"""The reader of ``traces.fused_pct``: the program's trace-build counters,
and nothing where the program has none (as before the trace kernel) or ran
no build on a card."""

import builtins
import sys
from types import SimpleNamespace

import pytest

from benchmark import spec
from pressurepoissonsolver_torch.ops import traces


def _read():
    return spec.reader("metrics", "traces.fused_pct").read(SimpleNamespace())


@pytest.mark.parametrize("kernel, plain, want", [
    ({"float32": 56, "float64": 4}, {"float32": 0, "float64": 0}, 100.0),
    ({"float32": 3, "float64": 1}, {"float32": 4, "float64": 0}, 50.0),
    ({"float32": 0, "float64": 0}, {"float32": 2, "float64": 0}, 0.0),
    ({"float32": 0, "float64": 0}, {"float32": 0, "float64": 0}, None),
])
def test_reads_the_share_of_kernel_builds(monkeypatch, kernel, plain, want):
    for name, counts in (("launches", kernel), ("plain", plain)):
        for k, v in counts.items():
            monkeypatch.setitem(getattr(traces, name), k, v)
    assert _read() == want


def test_reads_nothing_without_the_counters(monkeypatch):
    """A program without the module (the parent of the trace kernel), or
    with it but without the counters."""
    real = builtins.__import__

    def refuse(name, *args, **kw):
        if name.endswith("ops.traces"):
            raise ImportError(name)
        return real(name, *args, **kw)

    monkeypatch.delitem(sys.modules, "pressurepoissonsolver_torch.ops.traces")
    monkeypatch.setattr(builtins, "__import__", refuse)
    assert _read() is None
    monkeypatch.undo()
    monkeypatch.delattr(traces, "builds")
    assert _read() is None


@pytest.mark.parametrize("name", ["poisson2d-amr.ir", "poisson2d-amr-d4.ir",
                                  "poisson2d-amr-schur.gmg"])
def test_every_cell_reports_it(name):
    """All three cells build traces on every V-cycle level, so each lists
    the metric, of the layer of the trace build, moving ``dof_per_s``."""
    cell = spec.find_cell(name)
    m = next(m for m in cell.per_layer if m["name"] == "traces.fused_pct")
    assert m["layer"] == "ops.level_ops trace build" and m["moves"] == "dof_per_s"
    assert m["source"] == "program_counter" and m["unit"] == "%"
