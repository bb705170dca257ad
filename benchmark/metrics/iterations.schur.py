"""Interface iterations per solve (``solver.PoissonSolver.solve_schur``'s
BiCGStab on ``(I - S) gamma = interp(solve(f, 0))``), the mean over the
window's solves, as each solve returned them."""


def read(run):
    counts = [r.counts["iterations"] for r in run.records if "iterations" in r.counts]
    return sum(counts) / len(counts) if counts else None
