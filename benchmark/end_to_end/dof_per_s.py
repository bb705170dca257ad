"""Finest-level DOF times the solves completed in the window, over the
window's seconds: all the work over all the time (host clock)."""

from benchmark import stats


def read(run):
    completed = len(run.records) - sum(run.failed)
    return stats.rate(run.dof, completed, run.window_s)
