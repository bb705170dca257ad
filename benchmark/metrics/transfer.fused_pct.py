"""The share of the grid transfers (``gmg.GMGCycle.apply``'s restrictions
and prolong-adds) that ran as the program's transfer kernel: 100 × the
kernel's transfers ÷ every transfer the process ran on a CUDA device,
kernel or plain chain, read from the program's counters
(``ops.transfer.transfers()``) after the run.  Nothing to read where the
program has no such counters, or ran no transfer on a card."""

import importlib


def read(run):
    try:
        transfer = importlib.import_module("pressurepoissonsolver_torch.ops.transfer")
    except ImportError:
        return None
    transfers = getattr(transfer, "transfers", None)
    if transfers is None:
        return None
    counts = transfers()
    kernel = sum(counts["kernel"].values())
    total = kernel + sum(counts["plain"].values())
    return 100.0 * kernel / total if total else None
