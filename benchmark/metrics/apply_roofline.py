"""The finest f32 composite apply (``ops.level_ops.Level.apply``), cold, as
a share (%) of its bound: ``u`` read and ``A u`` written once at the card's
data-sheet HBM rate; its device time from a profiler trace of single
calls."""

from benchmark import layers


def read(run):
    return layers.apply_roofline(run)
