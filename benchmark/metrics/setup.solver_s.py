"""Host seconds of ``solver.PoissonSolver.__init__`` (levels, transfers,
the coarse inverse, uploads), synchronised."""


def read(run):
    return run.setup.get("solver_s")
