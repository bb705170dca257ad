"""Device nodes per one-launch solve of a 3D cell: the program's counter
``utils.graphs.launches["nodes"]`` (each piece's kernel, memcpy and memset
nodes times its passes, the guard kernels and the memset of the pass
counters) over a few unstamped one-launch solves, divided by their number
(``benchmark/spans.py``); nothing in a 2D cell."""

from benchmark import spans


def read(run):
    if int(run.config["D"]) != 3:
        return None
    s = spans.read(run)
    return None if s is None else s.get("nodes_per_solve")
