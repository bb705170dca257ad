"""Shared fixtures of the benchmark's CPU tests (``python3 -m pytest
benchmark/tests`` from the root of the repository)."""

import pytest

from benchmark import mesh, spec


def corner_mesh(uniform: int, corners: int, divide: int = 0, D: int = 2) -> dict:
    """A configuration's ``mesh`` entry: ``uniform`` uniform refinements,
    then the leaf at the origin refined ``corners`` times, then ``divide``
    uniform ones."""
    boxes = [[[0.0] * D, [2.0 ** -(uniform + i)] * D] for i in range(corners)]
    return {"uniform": uniform, "refine_inside": boxes, "divide": divide}


def stated(m: dict, n: int, D: int = 2) -> dict:
    """The facts a configuration states about its mesh ``m``."""
    t = mesh.build(m, D)
    P = len(t.leaves())
    return {"mesh": m, "n": n, "patches": P, "dof": P * n ** D,
            "leaf_levels": mesh.leaf_levels(t)}


#: each cell cut to a mesh and patch size a CPU test holds
SMALL = {
    "poisson2d-amr.ir": stated(corner_mesh(2, 2), 8),
    "poisson2d-amr-d4.ir": stated(corner_mesh(2, 1, divide=1), 4),
}


def small_cell(name: str) -> spec.Cell:
    cell = spec.find_cell(name)
    return cell._replace(config=dict(cell.config, **SMALL[name]))


@pytest.fixture(params=sorted(SMALL))
def cell(request) -> spec.Cell:
    """Each cell of ``BENCHMARK.json`` at a small size."""
    return small_cell(request.param)
