"""Device ms a solve of the 3D levels' plain per-side trace builds
(``ops.traces.build_or_plain``'s plain chain: the face stack, row gathers,
the trilinear case-template matmul and the elementwise passes), inside the
one-launch solve: the self time of the program's ``pps.traces.plain`` device
spans summed over a few stamped one-launch solves and divided by their
number (``benchmark/d3_spans.py``); nothing in a 2D cell or where the
program opens no such span."""

from benchmark import d3_spans


def read(run):
    s = d3_spans.read(run)
    return None if s is None else s.get("traces_ms")
