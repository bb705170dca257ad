"""The share of the per-side interface trace builds (the ``gf`` that the
composite apply, the block-Jacobi sweeps and the active-set smoothers read)
that ran as the program's trace kernel: 100 × the kernel's builds ÷ every
build the process ran on a CUDA device, kernel or plain chain, read from
the program's counters (``ops.traces.builds()``) after the run.  Nothing to
read where the program has no such counters, or ran no build on a card."""

import importlib


def read(run):
    try:
        traces = importlib.import_module("pressurepoissonsolver_torch.ops.traces")
    except ImportError:
        return None
    builds = getattr(traces, "builds", None)
    if builds is None:
        return None
    counts = builds()
    kernel = sum(counts["kernel"].values())
    total = kernel + sum(counts["plain"].values())
    return 100.0 * kernel / total if total else None
