"""The reader of ``smooth.fused_pct``: the program's sweep counters, and
nothing where the program has none (as before the sweep kernel) or ran no
sweep on a card."""

import builtins
from types import SimpleNamespace

import pytest

from benchmark import spec
from pressurepoissonsolver_torch.ops import patch_sweep


def _read():
    return spec.reader("metrics", "smooth.fused_pct").read(SimpleNamespace())


@pytest.mark.parametrize("kernel, plain, want", [
    ({"float32": 30, "float64": 0}, {"float32": 0, "float64": 0}, 100.0),
    ({"float32": 3, "float64": 1}, {"float32": 4, "float64": 0}, 50.0),
    ({"float32": 0, "float64": 0}, {"float32": 2, "float64": 0}, 0.0),
    ({"float32": 0, "float64": 0}, {"float32": 0, "float64": 0}, None),
])
def test_reads_the_share_of_kernel_sweeps(monkeypatch, kernel, plain, want):
    for name, counts in (("launches", kernel), ("plain", plain)):
        for k, v in counts.items():
            monkeypatch.setitem(getattr(patch_sweep, name), k, v)
    assert _read() == want


def test_reads_nothing_without_the_counters(monkeypatch):
    """A program without the module (the parent of the sweep kernel), or
    with it but without the counters."""
    real = builtins.__import__

    def refuse(name, *args, **kw):
        if name.endswith("patch_sweep"):
            raise ImportError(name)
        return real(name, *args, **kw)

    monkeypatch.delitem(__import__("sys").modules,
                        "pressurepoissonsolver_torch.ops.patch_sweep")
    monkeypatch.setattr(builtins, "__import__", refuse)
    assert _read() is None
    monkeypatch.undo()
    monkeypatch.delattr(patch_sweep, "sweeps")
    assert _read() is None
