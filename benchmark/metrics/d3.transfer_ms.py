"""Device ms a solve of the 3D levels' plain grid transfers
(``gmg.Transfer.restrict_plain`` / ``prolong_add_plain``: row gathers,
Kronecker or per-axis matmuls, concatenations and a routing gather), inside
the one-launch solve: the self time of the program's ``pps.transfer.plain``
device spans summed over a few stamped one-launch solves and divided by
their number (``benchmark/d3_spans.py``); nothing in a 2D cell or where the
program opens no such span."""

from benchmark import d3_spans


def read(run):
    s = d3_spans.read(run)
    return None if s is None else s.get("transfer_ms")
