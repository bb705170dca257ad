"""The share (%) of the one-launch solves' device span, from the first
piece's first stamp to the last piece's last, that no captured piece
(``pps.graphs.piece.*`` device span) covers: the WHILE nodes' guard kernels
and the child-graph transitions of ``utils.graphs.GraphLoop``, over a few
stamped one-launch solves (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    s = spans.read(run)
    return None if s is None else s.get("graph_gap_pct")
