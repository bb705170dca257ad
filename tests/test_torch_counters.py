"""The port's launch counting (``utils/counters.py``) and the layering it
allows, on the CPU.

Held: a table registered here is accounted by ``utils.graphs`` by its name
alone, once per replay of a piece and times the passes of a graph launch,
through an emulated capture; the deltas hold only what a piece touched; a
deferred report is read at the next snapshot and dropped by a reset; and
``utils/counters.py``, ``utils/graphs.py`` and ``cuda_build.py`` import no
module of ``ops`` (read with ``ast``), so no kernel is known to the graph
runner or to the build, and ``cuda_build.LIBRARIES`` names every library
the package loads."""

import ast
import sys
from pathlib import Path
from typing import NamedTuple

import pytest
import torch

from pressurepoissonsolver_torch import cuda_build
from pressurepoissonsolver_torch.krylov import While, _go
from pressurepoissonsolver_torch.utils import counters, graphs

PKG = Path(__file__).resolve().parent.parent / "pressurepoissonsolver_torch"
TABLE = "test_counters.piece"


def _emulated_capture(fn, device):
    """``graphs.capture`` on the CPU: the warm-up and the capture call run
    ``fn`` (the capture's call counts one call's); a replay runs ``fn``
    again with every counter held still, as a graph's replay does."""
    fn()
    before = counters.snapshot()
    fn()
    delta = counters.minus(counters.snapshot(), before)

    class Replay:
        def replay(self):
            snap = counters.snapshot()
            fn()
            counters.add(counters.minus(counters.snapshot(), snap), -1)

    return Replay(), delta


class _State(NamedTuple):
    k: torch.Tensor
    go: torch.Tensor


def test_a_registered_table_is_accounted_per_replay_and_per_pass(monkeypatch):
    monkeypatch.setattr(graphs, "capture", _emulated_capture)
    table = counters.table(TABLE, ("init", "step"))
    counters.reset()
    passes = 3

    def init(_):
        table["init"] += 1
        return _State(torch.zeros((), dtype=torch.int64), torch.ones((), dtype=torch.bool))

    def step(s):
        table["step"] += 2
        return _State(s.k + 1, s.k + 1 < passes)

    x = torch.zeros(1)
    gl = graphs.GraphLoop((x,), init, (While(_go, (step,)),), lambda: init(x), step, "cpu")
    # the set-up's counts are taken back; each piece's delta is by name and
    # holds only what it touched
    assert table == {"init": 0, "step": 0}
    assert gl.launches == {TABLE: {"step": 2}}
    assert gl.init.launches == {TABLE: {"init": 1}}
    runs = gl.replay()
    assert runs == [passes] and table == {"init": 1, "step": 2 * passes}
    counters.reset()
    gl.account([5])  # a graph launch that made 5 passes
    assert table == {"init": 1, "step": 10}
    counters.reset()


def test_minus_add_and_the_deferred_reports():
    table = counters.table(TABLE, ("init", "step"))
    assert counters.table(TABLE, ["init", "step"]) is table
    with pytest.raises(ValueError):
        counters.table(TABLE, ("step",))
    counters.reset()
    before = counters.snapshot()
    table["step"] += 4
    delta = counters.minus(counters.snapshot(), before)
    assert delta == {TABLE: {"step": 4}}
    counters.add(delta, -1)
    assert table == {"init": 0, "step": 0}
    counters.defer(lambda: counters.add(delta, 3))
    assert table["step"] == 0  # read at the next snapshot or flush
    assert counters.snapshot()[TABLE] == {"init": 0, "step": 12}
    counters.defer(lambda: counters.add(delta))
    counters.reset()  # drops the queued report
    counters.flush()
    assert table == {"init": 0, "step": 0}


def _imported(path: Path) -> set:
    """Every module ``path`` imports (at any depth of its code), as
    absolute names, with each name taken from a module."""
    package = ".".join(path.relative_to(PKG.parent).with_suffix("").parts[:-1])
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package.split(".")
                root = ".".join(parts[:len(parts) - node.level + 1])
                base = f"{root}.{base}" if base else root
            out.add(base)
            out.update(f"{base}.{a.name}" for a in node.names)
    return out


@pytest.mark.parametrize("rel", ["utils/counters.py", "utils/graphs.py", "cuda_build.py"])
def test_the_runtime_imports_no_kernel_module(rel):
    mods = _imported(PKG / rel)
    assert mods and not any(m.startswith("pressurepoissonsolver_torch.ops") or "level_ops" in m
                            for m in mods), sorted(mods)
    if rel == "utils/counters.py":
        top = {m.split(".")[0] for m in mods}
        assert top <= set(sys.stdlib_module_names) | {"__future__"}, top


def test_cuda_build_lists_every_library_the_package_loads():
    """Every library a kernel module loads is an entry of
    ``cuda_build.LIBRARIES``, whose sources exist, and every entry is
    loaded by one."""
    from pressurepoissonsolver_torch.ops import ghost_stencil, patch_sweep

    for sources, _ in cuda_build.LIBRARIES.values():
        assert sources and all((cuda_build.CSRC / s).is_file() for s in sources)
    named = set()
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "load_library"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                named.add(node.args[0].value)
    loaded = (named | {name for name, _ in ghost_stencil._LIBS.values()}
              | {f"patch_sweep_{suffix}" for suffix in patch_sweep._DTYPE_OF})
    assert loaded == set(cuda_build.LIBRARIES)
