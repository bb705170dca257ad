"""Process start to the first timed solve: imports, kernel-library load,
mesh, hierarchy, solver build, the right-hand-side pool, the first
(capturing) solve and the warm-up (host clock)."""


def read(run):
    return run.setup["setup_s"]
