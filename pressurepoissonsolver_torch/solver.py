"""High-level solves: GMG-preconditioned Krylov solves on the
composite operator, mixed-precision iterative refinement, and the
Schur-complement interface path.

Port of ``pressurepoissonsolver_tpu.solver`` for one device:

* ``solve``: BiCGStab, CG (in the cell-volume inner product) or GMRES on
  ``A u = f`` preconditioned by a GMG V- or W-cycle (reference ``--prec
  GMG --solver thunderegg``) or by one sweep of patch solves (Schwarz).
* ``solve_refined``: f64 iterative refinement around f32 inner solves
  (GMG-preconditioned BiCGStab, CG or Richardson).  The reference runs the
  whole outer loop in one jitted ``lax.while_loop``; so does the port on
  one CUDA device (the round's residual update, best iterate, stagnation
  and breakdown rules and the inner loop as pieces of one graph with
  nested WHILE nodes); elsewhere the outer round is host Python with the
  same rules, reading one scalar per round, around the inner loop.
* ``solve_schur``: eliminate the patch interiors, solve the interface
  system ``(I - S) gamma = interp(solve(f, 0))`` with BiCGStab or GMRES,
  then recover ``u`` by one more round of patch solves (reference
  ``--schur``).
* ``solve_monitored``: the composite or the Schur solve with a
  per-iteration relative-residual history (the CLI's ``--monitor``).

On one CUDA device every solve (``solve``, ``solve_refined``,
``solve_schur``, ``solve_monitored`` and ``solve_matrix``: BiCGStab, CG,
Richardson and GMRES, the monitored forms and the batched patch BiCGStab
of ``patch_solver="bcgs"`` included) runs as one graph launch, as the
reference runs it as one compiled program: the loop's init and pieces (the
preconditioner, the operator applies, the dots and axpys, the step counts
and the stop tests) are captured and composed into one graph whose loops
are WHILE nodes (``utils.graphs``), kept per entry point and method:
``("solve", krylov)``, ``("refined", inner_krylov)``, ``("schur",
preconditioner)`` for BiCGStab and ``("schur", preconditioner, "gmres")``,
``("monitored", method, schur, schur_preconditioner, max_iter)``,
``("matrix", kind, method)``.  A patch BiCGStab inside a piece (each
smoothing of a bcgs level, each Schur operator apply) becomes a loop of the
same graph (``utils.graphs.PieceLoop``).  The right-hand side, ``tol`` and
the step limits (``max_outer`` too, up to the history slots of the
capture) are copied into the graph's buffers, so they need no new capture.
A key's graph is built at its first solve, whose wall holds the capture.
After the launch the host makes one read (the counts, and a monitored
solve's history), or none (``solve_refined(sync=False)``).  The sharded
engines run eagerly; so do the CPU and the per-step replay, a host read per
guard.

With ``mesh`` (``parallel.sharding.make_mesh``) the solves run
patch-sharded, one rank per device, through the cut-face halo engine
(``comm="halo"``, the reference's default whenever a mesh is passed) or
the gathered engine (``comm="pjit"``, the counterpart of the reference's
XLA-partitioned engine, ``parallel.gathered``): every rank runs the same
calls on the same global inputs, keeps its block of ``P/k`` rows
(``_device_put``) and returns its block of the solution
(``parallel.sharding.gather_patches`` gives the global field); every dot,
norm and integral is summed over the ranks through one reduction hook.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import cuda_build
from .domain import DomainHierarchy
from .gmg import CycleOpts, build_gmg
from .krylov import (KrylovLoop, KrylovResult, While, _go, _norm, bicgstab_loop,
                     cg_history_loop, cg_loop, gmres_loop, host_read,
                     residual_history_loop, richardson_loop, run_program, solve_loop)
from .matrix import schur_block_jacobi
from .ops.level_ops import Level
from .precond import poly_cheb, schwarz
from .utils import profiling
from .utils.graphs import CapturedLoop, GraphLoop
from .utils.profiling import span

# the restart length of every GMRES solve (the reference's gmres default)
GMRES_RESTART = 30


@dataclass
class SolveOptions:
    tol: float = 1e-12
    max_iter: int = 1000
    gmg: CycleOpts = field(default_factory=CycleOpts)
    precondition: bool = True
    # dtype of the preconditioner levels; float32 gives mixed precision
    precond_dtype: torch.dtype = torch.float64
    dtype: torch.dtype = torch.float64
    krylov: str = "bicgstab"  # "bicgstab" | "cg" | "gmres"
    # inner Krylov method of the mixed-precision IR solve; "cg" runs in
    # the cell-volume inner product, in which the composite operator and
    # the V-cycle are self-adjoint
    inner_krylov: str = "bicgstab"  # "bicgstab" | "cg" | "richardson"
    preconditioner: str = "gmg"  # "gmg" | "schwarz" | "none"
    patch_solver: str = "dft"  # "dft" (spectral) | "bcgs" (iterative)
    # interface interpolation at refinement boundaries: "bilinear"
    # (reference BilinearInterpolator/TriLinInterp) or "quadratic" (2D
    # only; the reference's higher-order StencilHelper2d closures)
    iface_scheme: str = "bilinear"
    # multi-device communication schedule (only with a mesh): "halo" — the
    # explicit cut-face exchange (parallel.halo.ShardedLevel); "pjit" —
    # each op all-gathers the operand of its global gather
    # (parallel.gathered.GatheredLevel, the counterpart of the reference's
    # XLA-partitioned engine); "auto" — halo
    comm: str = "auto"


def _stamped() -> tuple:
    """The suffix of a ``_captured`` key under ``profiling.device_spans``:
    a graph captured with device stamps is never the timed one."""
    return ("stamped",) if profiling.device_spans_on() else ()


class PoissonSolver:
    """Composite-grid Poisson solver over a domain hierarchy, on ``device``
    (the CUDA card unless the caller asks for another).

    Pass ``mesh`` (a 1D ``DeviceMesh`` named ``("p",)``, see
    ``parallel.sharding.make_mesh``) to run every level, transfer and
    Krylov iteration patch-sharded over its ranks, ``device`` being this
    rank's; the hierarchy must have been built with
    ``DomainHierarchy(..., num_shards=mesh.size())``.  Inputs may be the
    global ``[P, ...]`` fields or this rank's block; results are this
    rank's block.  ``fine_level`` is then the global level on the host,
    whose tables the rank's engine took its rows from."""

    @profiling.spanned("pps.solver.init", device=False)
    def __init__(
        self,
        hierarchy: DomainHierarchy,
        options: Optional[SolveOptions] = None,
        mesh=None,
        *,
        device="cuda",
    ):
        self.hierarchy = hierarchy
        self.opts = options or SolveOptions()
        self.device = torch.device(device)
        self.mesh = mesh
        o = self.opts
        if o.comm not in ("auto", "halo", "pjit"):
            raise ValueError(f"comm={o.comm!r}: one of ('auto', 'halo', 'pjit')")
        if o.comm == "auto":
            o.comm = "halo"
        for name, val, ok in (
            ("krylov", o.krylov, ("bicgstab", "cg", "gmres")),
            ("inner_krylov", o.inner_krylov, ("bicgstab", "cg", "richardson")),
            ("preconditioner", o.preconditioner, ("gmg", "schwarz", "none")),
            ("patch_solver", o.patch_solver, ("dft", "bcgs")),
            ("iface_scheme", o.iface_scheme, ("bilinear", "quadratic")),
        ):
            if val not in ok:
                raise ValueError(f"{name}={val!r}: one of {ok}")
        if o.iface_scheme != "bilinear":
            # the higher-order closures are not self-adjoint in the volume
            # inner product: fall back to BiCGStab
            if o.krylov == "cg":
                o.krylov = "bicgstab"
            if o.inner_krylov == "cg":
                o.inner_krylov = "bicgstab"
        if self.device.type == "cuda":
            cuda_build.build_all()  # the kernel libraries, side by side
        # with a mesh the global levels stay on the host: a rank's device
        # holds only its rows and tables (parallel.halo.ShardedLevel,
        # parallel.gathered.GatheredLevel)
        self._host = self.device if mesh is None else torch.device("cpu")
        self.fine_level = Level(
            hierarchy.finest, dtype=o.dtype, device=self._host,
            iface_scheme=o.iface_scheme, patch_solver=o.patch_solver,
        )
        # the engine the solves run on, with the reduction hook of the
        # Krylov loops
        self._op = self._engine(self.fine_level)
        self._allreduce = None
        self._rows = slice(None)
        if mesh is not None:
            self._allreduce = self._op.comm.all_reduce
            self._rows = self._op._rows
        if o.preconditioner != "gmg":
            o.precondition = False
        self.gmg = None
        if o.precondition:
            same = o.precond_dtype == o.dtype
            self.gmg = build_gmg(
                hierarchy, o.gmg, dtype=o.precond_dtype, device=self.device,
                fine=self._op if same else None, mesh=mesh, comm=o.comm,
            )
        self._fine_low = None
        self._schur_M: dict = {}  # solve_schur's preconditioner -> M
        # on one CUDA device every loop runs as one graph launch
        # (``_run_loop``, ``solve_refined``): True.  A solver's only switch,
        # kept private so that tests can run the other ways beside it:
        # "steps" replays the same captured pieces one by one with a host
        # read per guard, False runs the loops eagerly
        self._graphs = self.device.type == "cuda" and mesh is None
        self._captured: dict = {}  # key -> CapturedLoop or _RefineGraph
        self._matrix_ops: dict = {}  # solve_matrix's key -> the A of its graph

    # -- operators ----------------------------------------------------------

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        return self._op.apply(u)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global ``[P, ...]`` field from every rank's block (``x``
        itself on one device)."""
        return self._op.gather(x)

    def _engine(self, level: Level):
        """``level`` itself, or with a mesh its sharded engine (``comm``) on
        this rank's device."""
        if self.mesh is None:
            return level
        from .parallel.rank_block import engine_classes

        return engine_classes(self.opts.comm)[0](level, self.mesh, self.device)

    def _preconditioner(self) -> Optional[Callable]:
        if self.opts.preconditioner == "schwarz":
            return schwarz(self._op)
        if self.gmg is None:
            return None
        pdtype, dtype = self.opts.precond_dtype, self.opts.dtype

        def M(r):
            return self.gmg.apply(r.to(pdtype)).to(dtype)

        return M

    def _as_field(self, f) -> torch.Tensor:
        return self._device_put(f, self.opts.dtype)

    def _device_put(self, x, dtype: torch.dtype) -> torch.Tensor:
        """``x`` on the solver's device in ``dtype``: with a mesh, this
        rank's block of rows of a global ``[P, ...]`` field (a rank's block
        is taken as it is), as a fresh tensor."""
        x = torch.as_tensor(x)
        if self.mesh is not None and x.shape[0] == self.fine_level.P:
            x = x[self._rows].clone()
        return x.to(device=self.device, dtype=dtype)

    def _volume_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """Per-cell volume weights ``[P, 1, ..]``: the inner product in
        which the composite operator and the V-cycle are exactly
        self-adjoint.  Normalized to mean 1: CG is invariant to a scalar
        rescaling of the inner product, and raw cell volumes (~h^D) make
        f32 weighted dots underflow as the residual shrinks."""
        pl = self.hierarchy.finest
        w = np.prod(pl.spacings, axis=1)
        w = w / w.mean()
        return self._device_put(w.reshape((pl.num_patches,) + (1,) * pl.D), dtype)

    # -- solves -------------------------------------------------------------

    def _run_loop(self, key: tuple, make: Callable[[], KrylovLoop], b: torch.Tensor,
                  tol: float, max_iter: int, prepare: Optional[Callable] = None,
                  finish: Optional[Callable] = None):
        """The Krylov loop ``make()`` on ``b`` (on ``prepare(b)`` with
        ``prepare``) to its stop: with ``_graphs``, from its pieces captured
        at the first solve of ``key`` (kept in ``_captured[key]`` with their
        capture seconds), as one graph launch (``_graphs == "steps"``: piece
        by piece), else eagerly.  With ``finish``: ``(result, finish(b,
        result))``, the field computed in the same launch
        (``utils.graphs.CapturedLoop``)."""
        if not self._graphs:
            res = solve_loop(make(), b if prepare is None else prepare(b), tol, max_iter)
            if finish is None:
                return res
            return res, finish(b, res[0] if _has_history(res) else res)
        key += _stamped()
        if key not in self._captured:
            self._captured[key] = CapturedLoop(make(), b, tol, max_iter, prepare, finish)
        return self._captured[key].run(b, tol, max_iter, one=self._graphs is True)

    def _schur_ends(self):
        """``(prepare, finish)`` of an interface solve (see ``_run_loop``):
        the right-hand side ``interp(solve(f, 0))`` from ``f`` (the span
        ``pps.solver.schur_rhs``), and the recovery ``solve(f, gamma)`` from
        a state or result whose ``x`` is ``gamma``, flat in GMRES's state
        (``pps.solver.schur_recover``)."""
        lvl = self._op

        def prepare(f):
            with span("pps.solver.schur_rhs"):
                return lvl.interpolate(lvl.patch_solve(f, lvl.gamma_zeros(f.dtype)))

        def finish(f, s):
            with span("pps.solver.schur_recover"):
                x = s.x if s.x.dim() > 1 else s.x.reshape(lvl.num_ifaces, -1)
                return lvl.patch_solve(f, x)

        return prepare, finish

    def solve(
        self,
        f,
        tol: Optional[float] = None,
        max_iter: Optional[int] = None,
    ) -> KrylovResult:
        """Preconditioned BiCGStab (or CG in the cell-volume inner product,
        or GMRES: ``opts.krylov``) on ``A u = f``."""
        tol = self.opts.tol if tol is None else tol
        max_iter = self.opts.max_iter if max_iter is None else max_iter
        A, b, red = self._op.apply, self._as_field(f), self._allreduce
        krylov = self.opts.krylov

        def make():
            M = self._preconditioner()
            if krylov == "gmres":
                return gmres_loop(A, M, GMRES_RESTART, red)
            if krylov == "cg":
                return cg_loop(A, M, self._volume_weight(self.opts.dtype), red)
            return bicgstab_loop(A, M, red)

        return self._run_loop(("solve", krylov), make, b, tol, max_iter)

    def solve_matrix(self, kind: str, A: Callable, b: torch.Tensor, method: str = "bicgstab",
                     M: Optional[Callable] = None, weight: Optional[torch.Tensor] = None,
                     tol: Optional[float] = None, max_iter: Optional[int] = None,
                     prepare: Optional[Callable] = None, finish: Optional[Callable] = None):
        """A Krylov solve (``method``: BiCGStab, CG in the inner product of
        ``weight``, or GMRES) on a caller's operator ``A``, such as the
        product of an assembled matrix (the CLI's ``--matrix-type crs`` and
        ``pbm``), preconditioned by ``M``; ``b`` on the solver's device.
        One graph launch per solve on one CUDA device, as the reference's
        ``jax.jit(run)`` is one dispatch, under the key ``("matrix", kind,
        method)``; ``prepare`` and ``finish`` as ``_run_loop``'s (then
        ``(result, field)``).  The key's graph holds the ``A`` and ``M`` of
        its first solve: a solve with another ``A`` captures anew (``M``
        must be the same preconditioner, as the solver's own
        ``_preconditioner()``)."""
        tol = self.opts.tol if tol is None else tol
        max_iter = self.opts.max_iter if max_iter is None else max_iter
        red = self._allreduce
        key = ("matrix", kind, method)
        if self._matrix_ops.get(key) is not A:
            self._captured.pop(key, None)
            self._captured.pop(key + ("stamped",), None)
            self._matrix_ops[key] = A

        def make():
            if method == "gmres":
                return gmres_loop(A, M, GMRES_RESTART, red)
            if method == "cg":
                return cg_loop(A, M, None if weight is None else weight.to(b.dtype), red)
            return bicgstab_loop(A, M, red)

        return self._run_loop(key, make, b, tol, max_iter, prepare, finish)

    def solve_monitored(
        self,
        f,
        tol: Optional[float] = None,
        max_iter: int = 200,
        schur: bool = False,
        schur_preconditioner: Optional[str] = None,
    ):
        """Solve with a per-iteration residual-norm history (the
        observability hook behind the CLI ``--monitor`` flag).

        Returns ``(u, KrylovResult, history)`` where ``history[k]`` is the
        *relative* residual norm after iteration ``k``, ``k = 0 ..
        iterations`` (host numpy).  Honors ``opts.krylov`` (bicgstab / cg /
        gmres; for GMRES the in-cycle entries are the running Givens
        estimates, corrected to the true residual at each restart
        boundary), on the composite system or, with ``schur``, on the
        interface system preconditioned by ``schur_preconditioner`` (as
        ``solve_schur``'s).  The loops stop at convergence."""
        method = self.opts.krylov
        tol = self.opts.tol if tol is None else tol
        lvl = self._op
        f = self._as_field(f)
        weight = None
        ends = ()
        if schur:
            M = self._schur_preconditioner(schur_preconditioner)
            ends = self._schur_ends()

            def A(g):
                return g - lvl.schur_S(g)

        else:
            A, M = lvl.apply, self._preconditioner()
            if method == "cg":
                weight = self._volume_weight(self.opts.dtype)
        red = self._allreduce

        def make():
            if method == "gmres":
                return gmres_loop(A, M, GMRES_RESTART, red, max_iter + GMRES_RESTART + 1)
            if method == "cg":
                return cg_history_loop(A, M, weight, red, max_iter + 1)
            return residual_history_loop(A, M, red, max_iter + 1)

        # the history's slots depend on max_iter, so it is in the key
        key = ("monitored", method, schur, schur_preconditioner, max_iter)
        out = self._run_loop(key, make, f, tol, max_iter, *ends)
        (res, hist), u = out if schur else (out, out[0].x)
        r0 = hist[0]  # ||r0||, read with the history
        rel = np.asarray(hist) / (r0 if r0 > 0 else 1.0)
        return u, res, rel[: res.iterations + 1]

    @profiling.spanned("pps.solver.solve_refined", solve=True)
    def solve_refined(
        self,
        f,
        tol: Optional[float] = None,
        inner_tol: float = 1e-5,
        max_outer: int = 12,
        inner_max_iter: int = 60,
        sync: bool = True,
    ):
        """Mixed-precision iterative refinement: inner GMG-preconditioned
        solves (``opts.inner_krylov``: BiCGStab, CG in the cell-volume
        inner product, or Richardson) in the preconditioner dtype (f32),
        residual updates in f64.

        The loop (the rounds, their residual update, best iterate,
        stagnation and breakdown rules, and the inner loop) is one program
        (:func:`_refinement`).  On one CUDA device it is one graph launch
        (:class:`_RefineGraph`); elsewhere it runs eagerly
        (``krylov.run_program``: a host read of the round's guard before
        each round and of the inner guard before each inner step).  With
        ``sync`` the counts are read once after it, and with ``sync=False``
        they stay on the device, as the reference leaves them: 0-d tensors
        (``outer_history`` 1-d, ``max_outer + 1`` slots, 1 where no round
        wrote) and no read after the loop.  The call
        is the span ``pps.solver.solve_refined``, one solve; under
        ``profiling.device_spans`` its graph is captured with stamps, under
        its own key.

        The inner operator is the cycle's finest level when it has the
        preconditioner dtype, else a bilinear level of that dtype: with the
        quadratic closures and an f32 cycle (whose levels are bilinear) the
        inner solves invert the bilinear operator while the outer residual
        is quadratic, as in the reference.

        Returns ``(u, info)`` with ``outer_iterations`` (refinement rounds),
        ``inner_iterations`` (total inner iterations), ``residual`` (the
        final relative residual) and ``outer_history``."""
        tol = self.opts.tol if tol is None else tol
        pdtype = self.opts.precond_dtype
        if self._fine_low is None:
            if self.gmg is not None and self.gmg.levels[0].dtype == pdtype:
                self._fine_low = self.gmg.levels[0]
            else:
                self._fine_low = self._engine(Level(self.hierarchy.finest, dtype=pdtype,
                                                    device=self._host))
        low = self._fine_low
        M = self.gmg.apply if self.gmg is not None else None
        apply64 = self._op.apply
        inner = self.opts.inner_krylov
        red = self._allreduce

        def make():
            if inner == "cg":
                return cg_loop(low.apply, M, self._volume_weight(pdtype), red)
            method = richardson_loop if inner == "richardson" else bicgstab_loop
            return method(low.apply, M, red)

        f = self._as_field(f)
        if self._graphs:
            key = ("refined", inner) + _stamped()
            entry = self._captured.get(key)
            if entry is None or entry.slots < max_outer + 1:
                entry = self._captured[key] = _RefineGraph(
                    make(), apply64, f, tol, pdtype, max_outer, inner_tol, inner_max_iter,
                    red)
            return entry.run(f, tol, max_outer, inner_tol, inner_max_iter,
                             one=self._graphs is True, sync=sync)
        inputs = _refine_inputs(f, tol, max_outer, inner_tol, inner_max_iter, pdtype)
        init, _, body, _ = _refinement(make(), apply64, pdtype, max_outer + 1, red, *inputs)
        s = run_program(init(f), body)
        return _refined(s, max_outer, host_read(*_read(s)) if sync else None)

    def schur_gmg_preconditioner(self) -> Callable:
        """Interface preconditioner from the composite GMG (Woodbury).

        With ``A = K + G Γ`` (block patch stencil ``K`` plus the ghost
        injection ``G`` of the interpolated traces ``Γ``) the interface
        matrix factors exactly as ``(I - S)⁻¹ = (I + Γ K⁻¹ G)⁻¹ = I - Γ
        A⁻¹ G``; one V-cycle ``M_A`` in place of ``A⁻¹`` gives ``M = I - Γ
        M_A G``.  One application: a ghost injection, a V-cycle in the
        preconditioner dtype and a trace interpolation, the casts around
        the V-cycle as in the reference."""
        if self.gmg is None:
            self.gmg = build_gmg(self.hierarchy, self.opts.gmg,
                                 dtype=self.opts.precond_dtype, device=self.device,
                                 mesh=self.mesh, comm=self.opts.comm)
        lvl = self._op
        gmg = self.gmg
        pdtype = self.opts.precond_dtype

        def M(rho):
            zf = lvl.zeros().to(rho.dtype)
            g = lvl.fold_gamma(zf, rho)  # = -G rho
            e = gmg.apply(g.to(pdtype)).to(rho.dtype)
            return rho + lvl.interpolate(e)  # = rho - Γ M_A G rho

        return M

    @profiling.spanned("pps.solver.solve_schur", solve=True)
    def solve_schur(
        self,
        f,
        tol: Optional[float] = None,
        max_iter: Optional[int] = None,
        preconditioner: Optional[str] = None,
    ):
        """Schur-complement path (reference ``--schur``).

        The interface condition ``gamma = interp(solve(f, gamma))``
        (``SchurHelper.h:281-299``) is the linear system ``(I - S) gamma =
        interp(solve(f, 0))`` with ``S = interp(solve(0, .))``, solved by
        ``opts.krylov`` preconditioned by ``preconditioner``: ``None``,
        ``"cheb"`` (Chebyshev polynomial of ``S``), ``"blockjacobi"`` (the
        inverse diagonal blocks of the probed ``I - S``) or ``"gmg"`` (the
        Woodbury V-cycle).  A preconditioner is built once per solver and
        kept.  The call is the span ``pps.solver.solve_schur``, one solve;
        under ``profiling.device_spans`` its graph is captured with stamps,
        under its own key.  Returns ``(u, KrylovResult)``."""
        tol = self.opts.tol if tol is None else tol
        max_iter = self.opts.max_iter if max_iter is None else max_iter
        lvl, red = self._op, self._allreduce
        M = self._schur_preconditioner(preconditioner)
        f = self._as_field(f)

        def A(g):
            return g - lvl.schur_S(g)

        # the right-hand side and the recovery run in the solve's launch
        ends = self._schur_ends()
        if self.opts.krylov == "gmres":
            res, u = self._run_loop(("schur", preconditioner, "gmres"),
                                    lambda: gmres_loop(A, M, GMRES_RESTART, red), f, tol,
                                    max_iter, *ends)
        else:
            res, u = self._run_loop(("schur", preconditioner),
                                    lambda: bicgstab_loop(A, M, red), f, tol, max_iter, *ends)
        return u, res

    def _schur_preconditioner(self, preconditioner: Optional[str]) -> Optional[Callable]:
        """The interface preconditioner ``preconditioner`` (see
        ``solve_schur``), built at first use and kept."""
        if preconditioner not in (None, "cheb", "blockjacobi", "gmg"):
            raise ValueError(f"preconditioner={preconditioner!r}: None, 'cheb', "
                             "'blockjacobi' or 'gmg'")
        if preconditioner not in self._schur_M:
            lvl = self._op
            M = None
            if preconditioner == "cheb":
                M = poly_cheb(lvl)
            elif preconditioner == "blockjacobi":
                M = schur_block_jacobi(
                    self.fine_level, engine=lvl if self.mesh is not None else None)
            elif preconditioner == "gmg":
                M = self.schur_gmg_preconditioner()
            self._schur_M[preconditioner] = M
        return self._schur_M[preconditioner]

    # -- diagnostics --------------------------------------------------------

    def report(self, u, f, exact, neumann: bool = False) -> dict:
        """Error/residual/conservation block (``apps/2d/steady.cpp:570-606``).

        Sharded levels carry padded dummy patches, which every metric here
        leaves out (``init_problem`` gives them zero data; the mask keeps a
        caller's nonzero pads out too)."""
        lvl, red = self._op, self._allreduce
        u, f, exact = (self._as_field(x) for x in (u, f, exact))
        pl = self.fine_level.pl
        mask = None
        if pl.real_patches < pl.num_patches:
            real = (np.arange(pl.num_patches) < pl.real_patches)[self._rows]
            mask = torch.as_tensor(real.reshape((-1,) + (1,) * pl.D), device=self.device)
            u, f, exact = (torch.where(mask, x, torch.zeros_like(x)) for x in (u, f, exact))
        au = self.apply(u)
        if mask is not None:
            au = torch.where(mask, au, torch.zeros_like(au))
        resid = f - au
        out = {"residual": float((_norm(resid, red) / _norm(f, red)).item())}
        err = exact - u
        if neumann:
            # compare modulo the constant nullspace: shift the error to zero
            # mean (reference apps/2d/steady.cpp:588-599)
            uavg = lvl.integrate(u) / lvl.volume
            eavg = lvl.integrate(exact) / lvl.volume
            err = err - (eavg - uavg)
            if mask is not None:
                err = torch.where(mask, err, torch.zeros_like(err))
        out["error"] = float((_norm(err, red) / _norm(exact, red)).item())
        out["conservation"] = float((lvl.integrate(au) - lvl.integrate(f)).item())
        return out


def _has_history(res) -> bool:
    """Whether a loop's result is ``(KrylovResult, history)``."""
    return isinstance(res, tuple) and not isinstance(res, KrylovResult)


class _Refinement(NamedTuple):
    fnorm: torch.Tensor
    u: torch.Tensor
    r: torch.Tensor
    best_u: torch.Tensor
    best_rel: torch.Tensor
    rel: torch.Tensor
    k: torch.Tensor  # rounds
    inner_total: torch.Tensor
    go: torch.Tensor  # another round: not stopped
    hist: torch.Tensor  # [slots], 1 where no round wrote
    inner: tuple  # the inner loop's state


def _inner_go(state) -> torch.Tensor:
    return state.inner.go


def _refine_inputs(f: torch.Tensor, tol, max_outer: int, inner_tol, inner_max_iter: int,
                   pdtype: torch.dtype) -> tuple:
    """``(f, tol, max_outer, inner_tol, inner_max_iter)``, the numbers as
    0-d tensors on ``f``'s device: the inputs of :func:`_refinement`."""
    def t(v, dtype):
        return torch.full((), v, dtype=dtype, device=f.device)

    return (f, t(tol, f.dtype), t(max_outer, torch.int64), t(inner_tol, pdtype),
            t(inner_max_iter, torch.int64))


def _refinement(inner: KrylovLoop, apply64: Callable, pdtype: torch.dtype, slots: int,
                red, f: torch.Tensor, tol: torch.Tensor, max_outer: torch.Tensor,
                inner_tol: torch.Tensor, inner_max_iter: torch.Tensor) -> tuple:
    """``solve_refined``'s loop as the reference's ``lax.while_loop``
    (``pressurepoissonsolver_tpu/solver.py:436-477``), over the inputs of
    :func:`_refine_inputs`: ``(init, begin, body, step)``.  ``init(f)`` is
    the state; ``body`` runs while not stopped a round of three parts, the
    inner Krylov init on ``r.to(pdtype)`` (``begin``), the inner loop (a
    nested loop of ``step``) and the round's end (the finite mask of
    ``e``, ``u_new``, the f64 residual, ``rel``, the best iterate,
    stagnation, breakdown, the stop flag and ``hist[k]``), all device
    work.  ``slots``: the history's length, at least ``max_outer + 1``."""
    dev = f.device

    def init(f):
        fnorm = _norm(f, red)
        fnorm = torch.where(fnorm > 0, fnorm, torch.ones_like(fnorm))
        u = torch.zeros_like(f)
        one = torch.ones((), dtype=f.dtype, device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return _Refinement(fnorm, u, f, u, one * math.inf, one, zero, zero,
                           torch.ones((), dtype=torch.bool, device=dev),
                           torch.ones(slots, dtype=f.dtype, device=dev), None)

    def begin(s):
        return s._replace(inner=inner.init(s.r.to(pdtype), inner_tol, inner_max_iter))

    def step(s):
        return s._replace(inner=inner.step(s.inner))

    def end(s):
        with span("pps.solver.round_end"):
            x = s.inner.x
            e = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
            u_new = s.u + e.to(s.u.dtype)
            r = f - apply64(u_new)
            rel_new = _norm(r, red) / s.fnorm
            breakdown = ~torch.isfinite(rel_new)
            improved = rel_new < s.best_rel
            k = s.k + 1
            stagnated = (k > 3) & (rel_new > 0.5 * s.best_rel) & (rel_new > 10 * tol)
            stop = breakdown | (rel_new <= tol) | stagnated | (k >= max_outer)
            # on breakdown, fall back to the best iterate so far
            rel = torch.where(breakdown, s.best_rel, rel_new)
            at = torch.arange(slots, device=dev) == k
            return s._replace(
                u=torch.where(breakdown, s.best_u, u_new), r=r,
                best_u=torch.where(improved, u_new, s.best_u),
                best_rel=torch.where(improved, rel_new, s.best_rel), rel=rel, k=k,
                inner_total=s.inner_total + s.inner.k, go=~stop,
                hist=torch.where(at, rel, s.hist))

    return init, begin, (While(_go, (begin, While(_inner_go, (step,)), end)),), step


def _read(s: _Refinement) -> tuple:
    """The fields of a refinement's final state that its info reads."""
    return s.k, s.inner_total, s.rel, s.hist


def _refined(s: _Refinement, max_outer: int, got) -> tuple:
    """``solve_refined``'s ``(u, info)`` from the final state ``s``: with
    ``got`` (:func:`_read`'s fields read to the host) host numbers, else
    (``sync=False``) the state's tensors cloned."""
    u = s.u.clone()
    if got is None:
        return u, {"outer_iterations": s.k.clone(), "inner_iterations": s.inner_total.clone(),
                   "residual": s.rel.clone(), "outer_history": s.hist[:max_outer + 1].clone()}
    k = int(got[0][0])
    return u, {"outer_iterations": k, "inner_iterations": int(got[1][0]),
               "residual": float(got[2][0]), "outer_history": got[3][:k + 1]}


class _RefineGraph:
    """The refinement program (:func:`_refinement`) composed into one graph
    (``utils.graphs.GraphLoop``) over static inputs: ``f``, ``tol``,
    ``max_outer``, ``inner_tol`` and ``inner_max_iter``.  ``slots``: the
    history's length, ``max_outer + 1`` at the capture; a solve with more
    rounds needs a new capture."""

    def __init__(self, inner: KrylovLoop, apply64: Callable, f: torch.Tensor, tol,
                 pdtype: torch.dtype, max_outer: int, inner_tol, inner_max_iter: int,
                 red=None):
        self.slots = max_outer + 1
        self.inputs = _refine_inputs(f.clone(), tol, max_outer, inner_tol, inner_max_iter,
                                     pdtype)
        init, begin, body, step = _refinement(inner, apply64, pdtype, self.slots, red,
                                              *self.inputs)
        self.graphs = GraphLoop(self.inputs[:1], init, body,
                                lambda: begin(init(self.inputs[0])), step, f.device)
        self.state = self.graphs.state
        self.graph, self.launches = self.graphs.graph, self.graphs.launches
        self.capture_s = self.graphs.capture_s

    def run(self, f, tol, max_outer: int, inner_tol, inner_max_iter: int, one: bool = True,
            sync: bool = True):
        """One solve: the inputs copied in, then on the card with ``one``
        one graph launch (else piece by piece, a host read per guard);
        with ``sync`` one read of the counts (with the passes, for the
        launch accounting), else none."""
        self.inputs[0].copy_(f)
        for buf, v in zip(self.inputs[1:], (tol, max_outer, inner_tol, inner_max_iter)):
            buf.fill_(v)
        _, got = self.graphs.run(one, *_read(self.state), sync=sync)
        return _refined(self.state, max_outer, got)


def shift_for_neumann(level: Level, f: torch.Tensor) -> torch.Tensor:
    """Zero the mean of f (Neumann compatibility, ``steady.cpp:330-334``)."""
    fdiff = level.integrate(f) / level.volume
    return f - fdiff.to(f.dtype)
