"""This rank's block of a global level: what both sharded engines share.

:class:`RankBlock` holds the rows ``r*P/k .. (r+1)*P/k - 1`` of a global
:class:`~pressurepoissonsolver_torch.ops.level_ops.Level` on this rank's
device (the stencil, fold and patch-solve data) and the ops that need no
data from another rank, or only a reduction or a gather of every rank's
block.  The cut-face halo engine (:class:`.halo.ShardedLevel`) and the
gathered engine of ``comm="pjit"`` (:class:`.gathered.GatheredLevel`)
subclass it and add the ops that read across patches, each with its own
communication.  :func:`engine_classes` picks an engine's level and
transfer classes by its ``comm`` name.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import patch_sweep
from ..ops.level_ops import Level, _build_solver_tables
from .sharding import Comm, row_block


class RankBlock:
    """This rank's ``[P/k, *ns]`` block of ``level`` on ``device``: the
    collectives (:class:`.sharding.Comm`), this rank's rows of ``h2inv``,
    ``ghost_coef``, ``ghost_coef_eff`` and the cell volumes, its patch
    solver tables, and the ops every engine computes alike.  ``level`` is
    the global level (build it on the host); only this rank's rows go to
    ``device``.  A subclass sets ``_gamma_rows``, the rows of this rank's
    block of the interface vector."""

    _gamma_rows = 1

    def __init__(self, level: Level, mesh, device=None):
        device = level.device if device is None else torch.device(device)
        self.base = level
        self.mesh = mesh
        self.comm = comm = Comm(mesh, device)
        self.ndev, self.me = comm.size, comm.rank
        self.D, self.n, self.m, self.P = level.D, level.n, level.m, level.P
        self.dtype, self.device = level.dtype, device
        self.pl = level.pl
        self.Pl = level.P // self.ndev
        self._rows = rows = row_block(level.P, mesh)
        self.face_depth = level.face_depth
        self.h2inv, self.ghost_coef, self.ghost_coef_eff, self._cellvol = (
            x[rows].to(device, copy=True)
            for x in (level.h2inv, level.ghost_coef, level.ghost_coef_eff,
                      level._cellvol))
        self._st = _build_solver_tables(level.pl, self.dtype,
                                        np.arange(level.P, dtype=np.int64)[rows], device)

    def _fold(self, fc: torch.Tensor, gf: torch.Tensor) -> torch.Tensor:
        return patch_sweep._fold_faces_flat(fc, gf, self.h2inv, self.D, self.n)

    def _solve(self, fc: torch.Tensor) -> torch.Tensor:
        return patch_sweep._spectral_apply(self._st, fc, self.D, self.n)

    def sweep(self, f: torch.Tensor, gf) -> torch.Tensor:
        """One block-Jacobi sweep of this rank's rows with the traces ``gf``
        (``None``: a zero iterate's), ``patch_sweep.sweep``."""
        return patch_sweep.sweep(self._st, f, gf, self.h2inv)

    def smooth_zero(self, f: torch.Tensor) -> torch.Tensor:
        """``smooth(f, 0)``: no traces, no collective, the local solves."""
        return self.sweep(f, None)

    def gamma_zeros(self, dtype=None) -> torch.Tensor:
        return torch.zeros((self._gamma_rows, self.m), dtype=dtype or self.dtype,
                           device=self.device)

    def patch_solve(self, f: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
        """Patch solves on this rank's rows with the interface values
        ``gamma`` (this rank's block)."""
        return self._solve(self.fold_gamma(f, gamma))

    def schur_S(self, gamma: torch.Tensor) -> torch.Tensor:
        """``S gamma = interp(patch_solve(0, gamma))``."""
        zf = torch.zeros((self.Pl,) + self.pl.ns_shape, dtype=gamma.dtype,
                         device=gamma.device)
        return self.interpolate(self.patch_solve(zf, gamma))

    def zeros(self) -> torch.Tensor:
        return torch.zeros((self.Pl,) + self.pl.ns_shape, dtype=self.dtype,
                           device=self.device)

    def integrate(self, u: torch.Tensor) -> torch.Tensor:
        """Volume integral over every rank (an all-reduce), in f64."""
        sums = u.reshape(self.Pl, -1).sum(dim=1)
        return self.comm.all_reduce((sums * self._cellvol).sum())

    @property
    def volume(self) -> float:
        return self.base.volume

    @property
    def num_ifaces(self) -> int:
        return self.base.num_ifaces

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global ``[P, ...]`` field from every rank's block."""
        return self.comm.all_gather(x)

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global ``[P, ...]`` field."""
        return x[self._rows]


def engine_classes(comm: str):
    """``(level class, transfer class)`` of the sharded engine ``comm``:
    ``"halo"`` the cut-face halo engine, ``"pjit"`` the gathered one."""
    if comm == "halo":
        from .halo import ShardedLevel, ShardedTransfer

        return ShardedLevel, ShardedTransfer
    if comm == "pjit":
        from .gathered import GatheredLevel, GatheredTransfer

        return GatheredLevel, GatheredTransfer
    raise ValueError(f"comm={comm!r}: 'halo' or 'pjit'")
