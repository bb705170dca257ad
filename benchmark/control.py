"""Readings for the limits of ``correct``: the program's sound runs over many
seeds, and its control, in one process per side.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 ... \\
        [--control-seeds 7 8 9] [--solves 8] [--seeded-problems] [--out control.json]

For each seed the right-hand-side pool is made anew and ``--solves`` solves
go through the cell's timed entry point, as a run's window drives it; their
answers are held against the plain reference (``harness.compare``).  With
``--seeded-problems`` each seed draws its own problems (the order of the
frequency vectors, the phases and the amplitudes) in place of the traffic's
fixed ones, so that the readings cover more than the problems a run
solves.  The
control is the program's own all-float32 path (``solve_options.dtype =
float32``: the refinement's residuals in float32, the nearest precision
below the float64 the configuration states), run the same way on
``--control-seeds``.  The benchmark's own runs never run it.  Needs a CUDA
card; ``benchmark/tests/test_harness_rehearsal.py`` runs :func:`readings` on
the CPU at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import harness, spec

CONTROL = {"dtype": "float32"}


def readings(cell: spec.Cell, seeds, solves: int, device, overrides=None,
             seeded: bool = False):
    """``[(seed, compared, counts)]`` of one solver built once and driven on
    each seed's pool (``seeded``: problems drawn from the seed); ``counts``
    the distinct counts the solves returned."""
    run = harness.Run(cell, seeds[0], torch.device(device))
    harness.build(run, overrides)
    harness.warm_up(run)
    out = []
    for seed in seeds:
        run.seed = seed
        harness.make_inputs(run, problem_seed=seed if seeded else None)
        run.records, run.sample, run.failed = [], [], []
        harness.loop(run, count=solves)
        counts = sorted({tuple(sorted(r.counts.items())) for r in run.records})
        out.append((seed, harness.compare(run), [dict(c) for c in counts]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--solves", type=int, default=8)
    ap.add_argument("--seeded-problems", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.find_cell(args.workload)
    result = {"workload": args.workload, "solves": args.solves,
              "seeded_problems": args.seeded_problems}
    for side, seeds, over in (("program", args.seeds, None),
                              ("control", args.control_seeds, CONTROL)):
        if not seeds:
            continue
        rows = readings(cell, seeds, args.solves, "cuda", over, args.seeded_problems)
        result[side] = [{"seed": s, **{k: v["value"] for k, v in c.items()}, "counts": n}
                        for s, c, n in rows]
        for s, c, n in rows:
            print(side, s, json.dumps(c), json.dumps(n), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
