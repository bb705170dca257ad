"""The mesh and the right-hand-side pool are made from the seed alone."""

import numpy as np
import torch

from benchmark import mesh, rhs

from .conftest import corner_mesh

MESH = corner_mesh(2, 2, 1)


def test_mesh_is_the_same_every_time(tmp_path):
    a, b = mesh.build(MESH, 2), mesh.build(MESH, 2)
    mesh.write_mesh(a, tmp_path / "a.bin")
    mesh.write_mesh(b, tmp_path / "b.bin")
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()
    sa, la = mesh.leaf_boxes(a)
    assert sa.shape == (len(a.leaves()), 2) and np.all(la > 0)


def _pool(seed, D=2):
    t = mesh.build(MESH, D)
    starts, lengths = mesh.leaf_boxes(t)
    probs = rhs.draw_pool(seed, D, 9, 3, 3, 0, (0.5, 1.0, 2.0))
    return probs, rhs.make_pool(starts, lengths, 4, probs, "cpu")


def test_same_seed_same_pool():
    big = 2 ** 40 + 123  # more than 32 signed bits hold
    (p1, f1), (p2, f2) = _pool(big), _pool(big)
    for a, b in zip(f1, f2):
        assert torch.equal(a, b)
    assert all(np.array_equal(a.amp, b.amp) for a, b in zip(p1, p2))


def test_seeds_differ_in_data_not_in_work():
    (p1, f1), (p2, f2) = _pool(1), _pool(2)
    assert any(not torch.equal(a, b) for a, b in zip(f1, f2))
    # the same problems, in another order and scaled by signed powers of two
    def key(p):
        return (tuple(p.k.ravel()), tuple(p.phase.ravel()))
    base1 = {key(p): p.amp for p in p1}
    base2 = {key(p): p.amp for p in p2}
    assert set(base1) == set(base2)
    for k in base1:
        ratio = base1[k] / base2[k]
        assert np.allclose(ratio, ratio[0])
        assert abs(ratio[0]) in (0.25, 0.5, 1.0, 2.0, 4.0)
    # each frequency vector of {1,2,3}^2 is used three times over the pool
    ks = np.concatenate([p.k for p in p1])
    assert sorted(map(tuple, ks)) == sorted(
        [(a, b) for a in (1.0, 2.0, 3.0) for b in (1.0, 2.0, 3.0)] * 3)


def test_no_right_hand_side_repeats_back_to_back():
    _, f = _pool(5)
    for a, b in zip(f, f[1:] + f[:1]):
        assert not torch.equal(a, b)
