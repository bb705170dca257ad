"""The benchmark of ``pressurepoissonsolver_torch`` on NVIDIA cards.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  One run is one process: it loads the
program, makes the cell's inputs from the seed, warms up, runs a closed loop
of one caller for ``--seconds`` (each solve starts when the previous one has
returned, synchronised: a time-stepping code's pressure projection), checks
a sample of the answers against the plain reference, and prints one JSON
object as the last line of standard output.  ``--trace 1`` also profiles a
short window of solves and reports the per-layer metrics instead of the
end-to-end ones.  The numbers compared with the reference are printed beside
their limits as the last lines of standard error and under ``compared``,
the line's last key.

Exits with 2, printing no result, without a CUDA card (or with fewer than
the cell asks for), and with 3 if a forbidden module (JAX, or the JAX
package) was loaded.
"""

from __future__ import annotations

import time

_T_PERF = time.perf_counter()


def _process_start() -> float:
    """``perf_counter()`` at this process's start (from ``/proc``, to the
    kernel's clock tick), else at this module's import."""
    import os

    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return _T_PERF


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache at a fixed path inside the checkout
CACHE = ROOT / "build" / "bench_cache"
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[_var] = str(CACHE / _sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, spec

    cell = spec.find_cell(args.workload)
    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA card(s), found {found}: no result", file=sys.stderr)
        return 2
    result = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                             "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}: no result", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
