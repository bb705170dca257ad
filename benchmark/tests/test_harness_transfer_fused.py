"""The reader of ``transfer.fused_pct``: the program's transfer counters,
and nothing where the program has none (as before the transfer kernel) or
ran no transfer on a card."""

import builtins
import sys
from types import SimpleNamespace

import pytest

from benchmark import spec
from pressurepoissonsolver_torch.ops import transfer


def _read():
    return spec.reader("metrics", "transfer.fused_pct").read(SimpleNamespace())


@pytest.mark.parametrize("kernel, plain, want", [
    ({"float32": 56, "float64": 0}, {"float32": 0, "float64": 0}, 100.0),
    ({"float32": 3, "float64": 1}, {"float32": 4, "float64": 0}, 50.0),
    ({"float32": 0, "float64": 0}, {"float32": 2, "float64": 0}, 0.0),
    ({"float32": 0, "float64": 0}, {"float32": 0, "float64": 0}, None),
])
def test_reads_the_share_of_kernel_transfers(monkeypatch, kernel, plain, want):
    for name, counts in (("launches", kernel), ("plain", plain)):
        for k, v in counts.items():
            monkeypatch.setitem(getattr(transfer, name), k, v)
    assert _read() == want


def test_reads_nothing_without_the_counters(monkeypatch):
    """A program without the module (the parent of the transfer kernel), or
    with it but without the counters."""
    real = builtins.__import__

    def refuse(name, *args, **kw):
        if name.endswith("ops.transfer"):
            raise ImportError(name)
        return real(name, *args, **kw)

    monkeypatch.delitem(sys.modules, "pressurepoissonsolver_torch.ops.transfer")
    monkeypatch.setattr(builtins, "__import__", refuse)
    assert _read() is None
    monkeypatch.undo()
    monkeypatch.delattr(transfer, "transfers")
    assert _read() is None


@pytest.mark.parametrize("name", ["poisson2d-amr.ir", "poisson2d-amr-d4.ir",
                                  "poisson2d-amr-schur.gmg"])
def test_every_cell_reports_it(name):
    """All three cells run the V-cycle's transfers, so each lists the
    metric, of the layer ``gmg.Transfer``, moving ``dof_per_s``."""
    cell = spec.find_cell(name)
    m = next(m for m in cell.per_layer if m["name"] == "transfer.fused_pct")
    assert m["layer"] == "gmg.Transfer" and m["moves"] == "dof_per_s"
    assert m["source"] == "program_counter" and m["unit"] == "%"
