"""Device nodes per one-launch interface solve: the program's counter
``utils.graphs.launches["nodes"]`` (each piece's kernel, memcpy and memset
nodes times its passes, the guard kernels and the memset of the pass
counters) over a few unstamped one-launch solves, divided by their number
(``benchmark/schur_spans.py``)."""

from benchmark import schur_spans


def read(run):
    s = schur_spans.read(run)
    return None if s is None else s.get("nodes_per_solve")
