"""Launch counting: the port's host counters, as named tables, and their
accounting across CUDA graphs.

A kernel's wrapper counts each launch in a table of plain integers that its
module registers here (:func:`table`) and keeps bound to a module-level
name, such as ``patch_sweep.launches`` (``"patch_sweep.kernel"``).  A CUDA
graph replays its kernels without passing the wrappers, so a captured
piece is accounted for by hand (``utils.graphs``): the difference of two
:func:`snapshot` around its capture (:func:`minus`) is the piece's
launches, taken back once (the capture ran nothing) and added once per
replay, or times the passes of a graph launch, with :func:`add`.  A launch
whose passes stay on the card until a later read
(``solve_refined(sync=False)``) queues a report (:func:`defer`), which
the next :func:`flush` (and so every :func:`snapshot` and every module's
reader) runs.

Every function works by table name.  A delta holds only the tables and
keys that changed, so adding one is a loop over what the piece touched.
This module imports nothing of the package: a kernel registers its tables
in its own module, and the graph runner knows none of them.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

_tables: Dict[str, dict] = {}
#: reports of launches counted on the card and not read yet
_pending: list = []


def table(name: str, keys: Iterable) -> dict:
    """The counter table ``name`` with ``keys``, each 0 at first; the same
    dict at every call."""
    keys = list(keys)
    t = _tables.setdefault(name, dict.fromkeys(keys, 0))
    if list(t) != keys:
        raise ValueError(f"counter table {name!r} has the keys {list(t)}, not {keys}")
    return t


def defer(report: Callable[[], None]) -> None:
    """Queue ``report()``, which reads launches counted on the card and
    adds them, for the next :func:`flush`."""
    _pending.append(report)


def flush() -> None:
    """Run the queued reports (:func:`defer`), oldest first."""
    while _pending:
        _pending.pop(0)()


def snapshot() -> Dict[str, dict]:
    """A copy of every table, after :func:`flush`."""
    flush()
    return {name: dict(t) for name, t in _tables.items()}


def minus(after: Dict[str, dict], before: Dict[str, dict]) -> Dict[str, dict]:
    """The counts between two :func:`snapshot`: per table that changed,
    its keys that changed."""
    out = {}
    for name, a in after.items():
        b = before.get(name, {})
        d = {k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)}
        if d:
            out[name] = d
    return out


def add(delta: Dict[str, dict], times: int = 1) -> None:
    """Add ``times`` the counts ``delta`` (a :func:`minus`) to the tables."""
    for name, d in delta.items():
        t = _tables[name]
        for k, v in d.items():
            t[k] += v * times


def reset() -> None:
    """Every table to 0; the queued reports are dropped."""
    _pending.clear()
    for t in _tables.values():
        for k in t:
            t[k] = 0
