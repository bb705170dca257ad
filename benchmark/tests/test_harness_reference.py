"""The plain composite-grid operator against the program's
``Level.apply`` on random vectors, 2D and 3D, bilinear closures."""

import numpy as np
import pytest
import torch

from benchmark import mesh, spec
from benchmark.reference.composite import CompositeOperator, relative_residual
from pressurepoissonsolver_torch import geometry
from pressurepoissonsolver_torch.domain import DomainHierarchy
from pressurepoissonsolver_torch.ops.level_ops import Level

from .conftest import corner_mesh

#: the graded quadtree of the 2D configurations
GRADED = spec.find_cell("poisson2d-amr.ir").config["mesh"]


@pytest.mark.parametrize("D,m", [(2, corner_mesh(2, 2, 1)), (2, corner_mesh(3, 3)),
                                 (3, corner_mesh(1, 2, D=3)), (3, corner_mesh(2, 1, 1, D=3)),
                                 (2, dict(GRADED, divide=0))])
@pytest.mark.parametrize("n", [4, 8])
def test_plain_operator_equals_level_apply(tmp_path, D, m, n):
    t = mesh.build(m, D)
    path = tmp_path / "m.bin"
    mesh.write_mesh(t, path)
    level = Level(DomainHierarchy(geometry.Tree.from_file(str(path), D), n=n).finest,
                  dtype=torch.float64, device="cpu")
    starts, lengths = mesh.leaf_boxes(t)
    op = CompositeOperator(starts, lengths, n)
    g = torch.Generator().manual_seed(n * 10 + D)
    for _ in range(2):
        u = torch.randn((len(starts),) + (n,) * D, dtype=torch.float64, generator=g)
        want, got = level.apply(u), op.apply(u)
        assert float((want - got).abs().max() / want.abs().max()) < 1e-13


def test_relative_residual_of_an_exact_and_a_perturbed_answer():
    t = mesh.build(corner_mesh(2, 1), 2)
    starts, lengths = mesh.leaf_boxes(t)
    op = CompositeOperator(starts, lengths, 4)
    u = torch.randn((len(starts), 4, 4), dtype=torch.float64)
    f = op.apply(u)
    assert relative_residual(op, u, f) < 1e-14
    assert relative_residual(op, u * (1 + 1e-8), f) > 1e-9


def test_unbalanced_or_open_meshes_are_refused():
    starts = np.array([[0.0, 0.0], [0.5, 0.0]])
    lengths = np.array([[0.5, 0.5], [0.5, 0.5]])
    with pytest.raises(ValueError):
        CompositeOperator(starts, lengths, 4)  # an inner face with no neighbour


def test_the_published_stand_in_mesh():
    """The 2D configurations' mesh: 520 leaves on 4 levels, 2:1 balanced
    (the reference operator finds a neighbour for every inner face), and
    8,320 leaves (2,129,920 DOF at n=16) at divide 2."""
    base = mesh.build(dict(GRADED, divide=0), 2)
    assert len(base.leaves()) == 520 and mesh.leaf_levels(base) == 4
    CompositeOperator(*mesh.leaf_boxes(base), 2)
    t = mesh.build(GRADED, 2)
    assert len(t.leaves()) * 16 ** 2 == 2129920 and mesh.leaf_levels(t) == 4
