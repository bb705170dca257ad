"""Device ms of one application of the matrix-free Schur operator
(``ops.level_ops.Level.schur_S``: the f64 patch solves of every patch with
the interface values folded in, then the trace interpolation) inside the
one-launch interface solve: the mean duration of the program's
``pps.level.schur_S`` device spans over a few stamped one-launch solves
(``benchmark/schur_spans.py``)."""

from benchmark import schur_spans


def read(run):
    s = schur_spans.read(run)
    return None if s is None else s.get("operator_ms")
