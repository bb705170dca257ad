"""Device ms of one application of the interface preconditioner (the
Woodbury form of one f32 V-cycle, ``solver.schur_gmg_preconditioner``: a
ghost fold, the cycle, a trace interpolation) inside the one-launch
interface solve: the mean duration of the program's ``pps.krylov.precond``
device spans under ``pps.solver.solve_schur`` over a few stamped one-launch
solves (``benchmark/schur_spans.py``)."""

from benchmark import schur_spans


def read(run):
    s = schur_spans.read(run)
    return None if s is None else s.get("precond_ms")
