"""Device ms a solve of the 3D levels' plain block-Jacobi sweeps
(``ops.patch_sweep.sweep_plain``: the fold, the batched spectral patch
solves in the Kronecker form, the routing of an active set), inside the
one-launch solve: the self time of the program's ``pps.patch_sweep.plain``
device spans summed over a few stamped one-launch solves and divided by
their number (``benchmark/d3_spans.py``); nothing in a 2D cell or where the
program opens no such span."""

from benchmark import d3_spans


def read(run):
    s = d3_spans.read(run)
    return None if s is None else s.get("sweep_ms")
