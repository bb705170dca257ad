"""The frozen copies under ``benchmark/`` against the program's originals:
the mesh generator and writer, and the right-hand side with its Dirichlet
walls.  (The tests may import the program; the run-time reference may
not.)"""

import math

import numpy as np
import pytest
from benchmark import mesh, rhs, spec
from pressurepoissonsolver_torch import geometry
from pressurepoissonsolver_torch.domain import DomainHierarchy
from pressurepoissonsolver_torch.problems import get_problem, init_problem

from .conftest import corner_mesh


def _program_tree(D, m):
    """The tree of the mesh entry ``m`` built with the program's own
    geometry: the same uniform, balanced and divide steps."""
    t = geometry.uniform_tree(D, m["uniform"] + 1)
    for lo, hi in m.get("refine_inside", ()):
        for nid in sorted(t.leaves()):
            node = t.nodes[nid]
            if (not node.has_children() and np.all(node.starts >= lo)
                    and np.all(node.starts + node.lengths <= hi)):
                geometry._refine_with_balance(t, nid)
    for _ in range(m.get("divide", 0)):
        t.refine_leaves()
    return t


@pytest.mark.parametrize("D,m", [(2, corner_mesh(4, 2, 1)), (3, corner_mesh(2, 2, 1, D=3)),
                                 (2, corner_mesh(2, 2)),
                                 (2, dict(spec.find_cell("poisson2d-amr.ir").config["mesh"],
                                          divide=0))])
def test_mesh_copy_equals_the_program_generator(tmp_path, D, m):
    ours = mesh.build(m, D)
    theirs = _program_tree(D, m)
    mesh.write_mesh(ours, tmp_path / "ours.bin")
    theirs.to_file(str(tmp_path / "theirs.bin"))
    assert (tmp_path / "ours.bin").read_bytes() == (tmp_path / "theirs.bin").read_bytes()
    read = geometry.Tree.from_file(str(tmp_path / "ours.bin"), D)
    fine = DomainHierarchy(read, n=4, use_native=False).finest
    starts, lengths = mesh.leaf_boxes(ours)
    assert np.array_equal(fine.starts, starts)
    assert np.array_equal(fine.spacings, lengths / 4)


# the reference apps' trig problems as modes of the benchmark's family
TRIG = {2: rhs.Modes(np.array([[2.0, 1.0]]), np.array([[0.0, -math.pi / 2]]),
                     np.array([1.0])),
        3: rhs.Modes(np.array([[1.0, 2.0 / 3, 5.0 / 6]]),
                     np.array([[0.3 * math.pi - math.pi / 2, 0.2 * math.pi,
                                0.25 * math.pi - math.pi / 2]]),
                     np.array([1.0]))}


@pytest.mark.parametrize("D,m,n", [(2, corner_mesh(2, 2, 1), 8),
                                   (3, corner_mesh(1, 2, D=3), 4)])
def test_rhs_copy_equals_init_problem(tmp_path, D, m, n):
    t = mesh.build(m, D)
    starts, lengths = mesh.leaf_boxes(t)
    _program_tree(D, m).to_file(str(tmp_path / "m.bin"))
    read = geometry.Tree.from_file(str(tmp_path / "m.bin"), D)
    level = DomainHierarchy(read, n=n, use_native=False).finest
    f_ref, g_ref = init_problem(level, get_problem("trig", D))
    f, g = rhs.fields(starts, lengths, n, TRIG[D], "cpu")
    scale = np.abs(f_ref).max()
    assert np.abs(f.numpy() - f_ref).max() <= 1e-12 * scale
    assert np.abs(g.numpy() - g_ref).max() <= 1e-12
