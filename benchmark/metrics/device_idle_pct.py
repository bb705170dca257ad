"""The share of the traced window in which no operation ran on the device:
1 - busy / window over a few back-to-back one-launch solves.  A hybrid of
two traces of the same solves (``harness.profile``): ``window`` spans the
benchmark's host spans of the one-launch solves, and ``busy`` is the union
of the kernel, memcpy and memset intervals of the same solves replayed piece
by piece, since the profiler records no kernel inside the one-launch path's
WHILE nodes."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
