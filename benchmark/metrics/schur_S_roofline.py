"""The finest f64 Schur operator apply (``ops.level_ops.Level.schur_S``),
cold, as a share (%) of the larger of its byte bound (``gamma`` read, the
patch field written and read once, ``S gamma`` written, at the card's
data-sheet HBM rate) and its flop bound (the patch solves' transforms at the
f64 peak); its device time from a profiler trace of 30 single calls
(``benchmark/schur_roofline.py``)."""

from benchmark import schur_roofline


def read(run):
    return schur_roofline.schur_S_roofline(run)
