"""The share of the block-Jacobi sweeps (``gmg.GMGCycle.apply``'s
smoothers) that ran as the program's sweep kernel: 100 × the kernel's
sweeps ÷ every sweep the process ran on a CUDA device, kernel or plain,
read from the program's counters (``ops.patch_sweep.sweeps()``) after the
run.  Nothing to read where the program has no such counters, or ran no
sweep on a card."""

import importlib


def read(run):
    try:
        patch_sweep = importlib.import_module("pressurepoissonsolver_torch.ops.patch_sweep")
    except ImportError:
        return None
    sweeps = getattr(patch_sweep, "sweeps", None)
    if sweeps is None:
        return None
    counts = sweeps()
    kernel = sum(counts["kernel"].values())
    total = kernel + sum(counts["plain"].values())
    return 100.0 * kernel / total if total else None
