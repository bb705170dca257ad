"""The 95th percentile (nearest rank) of the walls of all solves in the
window, from the call to its synchronised return; a failed solve counts
beyond every limit (host clock).  A per-layer metric, with no bound: it
swings with how much of the window a machine's slow start covers (PERF.md,
Open question 1)."""

from benchmark import stats


def read(run):
    return 1e3 * stats.percentile([r.wall_s for r in run.records], run.failed, 95)
