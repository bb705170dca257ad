"""Host seconds of the first solve, which captures the program's graphs,
synchronised."""


def read(run):
    return run.setup.get("first_solve_s")
