"""Readings of an interface cell's answers against both plain references:
the composite residual that decides ``correct`` (``harness.compare``) and
the interface residual of ``reference/schur.py``, beside the solves' own
returned residuals.

    python3 -m benchmark.schur_check --workload <cell> --seeds 1 2 3 ... \\
        [--solves 9] [--seeded-problems] [--control] [--out check.json]

One solver is built and driven on each seed's pool as a run's window drives
it (``--solves`` solves, a sample of 8 answers kept as a run keeps it;
``--seeded-problems``: each seed draws its own problems, as
``benchmark.control`` does; ``--control``: the all-float32 control).  Then
the program is freed (``harness.free_program``) and the sampled answers of
every seed are held against both references.  Needs a CUDA card;
``benchmark/tests/test_harness_schur.py`` runs :func:`readings` on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import control, harness, spec
from .reference.schur import SchurReference


def readings(cell: spec.Cell, seeds, solves: int, device, overrides=None,
             seeded: bool = False) -> list:
    """Per seed: the composite residual (``harness.compare``'s), the
    largest interface residual of the sample and the largest residual the
    solves returned."""
    run = harness.Run(cell, seeds[0], torch.device(device))
    harness.build(run, overrides)
    harness.warm_up(run)
    kept = []
    for seed in seeds:
        run.seed = seed
        harness.make_inputs(run, problem_seed=seed if seeded else None)
        run.records, run.sample, run.failed = [], [], []
        harness.loop(run, count=solves)
        kept.append((seed, list(run.pool), list(run.sample), list(run.records),
                     list(run.failed)))
    harness.free_program(run)
    ref = SchurReference(run.starts, run.lengths, run.n, device=run.device)
    out = []
    for seed, pool, sample, records, failed in kept:
        run.pool, run.sample, run.records, run.failed = pool, sample, records, failed
        compared = harness.compare(run)
        out.append({"seed": seed,
                    "reference_residual": compared["reference_residual"]["value"],
                    "interface_residual": max(ref.interface_residual(u, pool[j])
                                              for j, u in sample),
                    "returned_residual": max(r.residual for r in records),
                    "failed_solves": compared["failed_solves"]["value"],
                    "iterations": sorted({r.counts.get("iterations") for r in records})})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--solves", type=int, default=9)
    ap.add_argument("--seeded-problems", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.find_cell(args.workload)
    rows = readings(cell, args.seeds, args.solves, "cuda",
                    control.CONTROL if args.control else None, args.seeded_problems)
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "control": args.control,
                       "seeded_problems": args.seeded_problems, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
