"""Seeded right-hand sides: manufactured problems made on the device.

Each problem's exact solution is a sum of separable modes

    g(x) = sum_m a_m prod_d cos(pi k_{m,d} x_d + phi_{m,d}),

so ``f = laplacian(g) = -pi^2 sum_m |k_m|^2 g_m``, sampled at the cell
centres of the finest composite level.  The reference apps' ``trig``
problems are single modes of this family (2D: ``k = (2, 1)``, phases ``(0,
-pi/2)``).  Dirichlet walls are folded into ``f`` as the reference apps do
(``apps/shared/Init.cpp``): a boundary cell gets ``f -= 2 g(x_wall) / h^2``,
with ``x_wall`` the cell centre moved onto the wall along the side's axis.
This is the benchmark's own copy of that arithmetic
(``pressurepoissonsolver_torch.problems.init_problem``; the copy is held equal
to it by ``benchmark/tests/test_harness_copies.py``).

Every seed gets the same work.  The pool's problems are fixed by the
traffic's ``problem_seed`` (the frequency vectors of ``{1..kmax}^D`` in a
fixed order, the phases and the amplitudes); ``--seed`` draws their order
and scales each by a signed power of two.  The solver's relative tolerance
and every operation of the solve are exact under such a scaling, so each
problem takes the same iterations on every seed, while the data of
consecutive solves and of two seeds differ.  (With seeded phases the
number of inner iterations of a 3D problem is 7 or 8 at random, and a
pool's share of the slower ones moved its mean wall by 4% and its 95th
percentile by 10% from seed to seed.)
"""

from __future__ import annotations

import itertools
import math
from typing import List, NamedTuple

import numpy as np
import torch


class Modes(NamedTuple):
    k: np.ndarray  # [M, D] frequencies (multiples of pi)
    phase: np.ndarray  # [M, D]
    amp: np.ndarray  # [M]


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per use of the seed (any whole number)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, stream]))


def draw_pool(seed: int, D: int, pool: int, modes: int, kmax: int,
              problem_seed: int = 0, scales=(0.5, 1.0, 2.0)) -> List[Modes]:
    """``pool`` problems of ``modes`` modes each: fixed by
    ``problem_seed``, ordered and scaled by ``seed``."""
    fixed = rng_for(problem_seed, 1)
    combos = np.array(list(itertools.product(range(1, kmax + 1), repeat=D)), dtype=float)
    need = pool * modes
    order = np.concatenate([fixed.permutation(len(combos))
                            for _ in range(-(-need // len(combos)))])[:need]
    base = []
    for i in range(pool):
        k = combos[order[i * modes:(i + 1) * modes]]
        phase = fixed.uniform(0.0, 2 * math.pi, size=(modes, D))
        amp = fixed.uniform(0.5, 1.5, size=modes) * fixed.choice([-1.0, 1.0], size=modes)
        base.append(Modes(k, phase, amp))
    rng = rng_for(seed, 1)
    scale = rng.choice(np.asarray(scales, dtype=float), size=pool) * rng.choice(
        [-1.0, 1.0], size=pool)
    return [base[i]._replace(amp=base[i].amp * scale[j])
            for j, i in enumerate(rng.permutation(pool))]


def _axis_shape(D: int, a: int, n: int, P: int):
    """Broadcast shape of a per-axis factor ``[P, n]`` of spatial axis ``a``
    in a ``[P, *ns]`` field (x fastest, so axis ``a`` is array axis
    ``1 + D - 1 - a``)."""
    shape = [P] + [1] * D
    shape[1 + (D - 1 - a)] = n
    return shape


def fields(starts: np.ndarray, lengths: np.ndarray, n: int, problem: Modes,
           device, dtype=torch.float64):
    """``(f, g)``: the right-hand side with the walls folded in, and the
    exact solution, each ``[P, *ns]`` on ``device``."""
    P, D = starts.shape
    st = torch.as_tensor(starts, dtype=torch.float64, device=device)
    L = torch.as_tensor(lengths, dtype=torch.float64, device=device)
    h = L / n
    idx = torch.arange(n, dtype=torch.float64, device=device) + 0.5
    centres = st[:, :, None] + h[:, :, None] * idx  # [P, D, n]
    walls = {False: starts == 0.0, True: starts + lengths == 1.0}  # [P, D] each
    f = torch.zeros((P,) + (n,) * D, dtype=torch.float64, device=device)
    g = torch.zeros_like(f)
    for m in range(len(problem.amp)):
        k, ph, a = problem.k[m], problem.phase[m], float(problem.amp[m])
        fac = [torch.cos(math.pi * float(k[d]) * centres[:, d] + float(ph[d]))
               for d in range(D)]
        gm = a * _outer(fac, D, n, P)
        g += gm
        f += (-math.pi ** 2 * float(np.sum(k * k))) * gm
        for ax in range(D):
            for upper in (False, True):
                if not walls[upper][:, ax].any():
                    continue
                on_wall = torch.as_tensor(walls[upper][:, ax], device=device)
                w = st[:, ax] + L[:, ax] if upper else st[:, ax]
                wall = torch.cos(math.pi * float(k[ax]) * w + float(ph[ax]))  # [P]
                face = a * wall.reshape([P] + [1] * D)
                for d in range(D):
                    if d != ax:
                        face = face * fac[d].reshape(_axis_shape(D, d, n, P))
                arr_ax = 1 + (D - 1 - ax)
                layer = n - 1 if upper else 0
                scale = torch.where(on_wall, 2.0 / h[:, ax] ** 2, torch.zeros_like(h[:, ax]))
                term = (scale.reshape([P] + [1] * D) * face).select(arr_ax, 0)
                f.select(arr_ax, layer).sub_(term)
    return f.to(dtype), g.to(dtype)


def _outer(fac, D: int, n: int, P: int) -> torch.Tensor:
    out = None
    for d in range(D):
        t = fac[d].reshape(_axis_shape(D, d, n, P))
        out = t if out is None else out * t
    return out


def make_pool(starts, lengths, n: int, problems: List[Modes], device,
              dtype=torch.float64) -> List[torch.Tensor]:
    """The right-hand sides of ``problems`` on ``device``."""
    return [fields(starts, lengths, n, p, device, dtype)[0].contiguous() for p in problems]
