"""Device ms of one application of the Krylov operator (the f32 composite
``ops.level_ops.Level.apply``) inside the one-launch solve: the mean
duration of the program's ``pps.krylov.operator`` device spans over a few
stamped one-launch solves (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    s = spans.read(run)
    return None if s is None else s.get("operator_ms")
