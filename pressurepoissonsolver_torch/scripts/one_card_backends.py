"""What the process-group backends do with two ranks on one card::

    python -m pressurepoissonsolver_torch.scripts.one_card_backends

The sharded solve runs a world of several ranks on one card only for
correctness runs (``chip_smoke.py`` phase 7), and ``parallel.sharding.Comm``
stages gloo's collectives through host tensors when the tensors are on a
card.  This script records why.  Per probe it spawns a world of two ranks,
both on ``cuda:0`` (``spawn`` context, a ``FileStore`` in a temporary
directory), and prints one JSON line: each rank's exit code, whether the
collective gave the right values, and the lines of each rank's standard
error that name an error.  A world that outlives ``--timeout`` seconds is
killed and marked so.  The probes:

* ``nccl_all_reduce``: NCCL, one ``all_reduce`` of a CUDA tensor;
* ``gloo_all_reduce_cuda``: gloo, one ``all_reduce`` of a CUDA tensor;
* ``gloo_send_recv_cuda``: gloo, one ``send``/``recv`` of a CUDA tensor;
* ``gloo_send_recv_host``: gloo, one ``send``/``recv`` of a host tensor
  (what ``Comm`` does when it stages).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

PROBES = ("nccl_all_reduce", "gloo_all_reduce_cuda", "gloo_send_recv_cuda",
          "gloo_send_recv_host")
# words that mark a line of a rank's standard error as an error message
ERROR_WORDS = ("Error", "error", "Exception", "Duplicate", "abort", "Abort")


def _child(rank: int, probe: str, tmp: str) -> None:
    fd = os.open(os.path.join(tmp, f"{probe}.{rank}.err"),
                 os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 2)
    torch.cuda.set_device(0)
    backend = probe.split("_")[0]
    dist.init_process_group(backend, rank=rank, world_size=2,
                            store=dist.FileStore(os.path.join(tmp, f"{probe}.store"), 2))
    x = torch.full((4,), float(rank + 1),
                   device="cpu" if probe.endswith("host") else "cuda")
    if "all_reduce" in probe:
        dist.all_reduce(x)
        want = 3.0
    else:
        if rank == 0:
            dist.send(x, 1)
        else:
            dist.recv(x, 0)
        want = 1.0
    ok = bool((x == want).all())
    torch.cuda.synchronize()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"{probe}.{rank}.ok"), "w") as fh:
        fh.write("1" if ok else "0")


def run_probe(probe: str, tmp: str, timeout: float) -> dict:
    """One probe's world of two ranks on ``cuda:0``: its JSON record."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, probe, tmp)) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    timed_out = any(p.is_alive() for p in procs)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    rec = {"probe": probe, "exit_codes": [p.exitcode for p in procs],
           "timed_out": timed_out, "values_ok": [], "errors": []}
    for r in range(2):
        ok_path = os.path.join(tmp, f"{probe}.{r}.ok")
        rec["values_ok"].append(open(ok_path).read() == "1"
                                if os.path.exists(ok_path) else None)
        with open(os.path.join(tmp, f"{probe}.{r}.err"), errors="replace") as fh:
            lines = [ln.strip()[:300] for ln in fh if any(w in ln for w in ERROR_WORDS)]
        rec["errors"].append(lines[-3:])
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds a probe's world may take")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes need a card")
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}", flush=True)
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for probe in PROBES:
            rec = run_probe(probe, tmp, args.timeout)
            print(json.dumps(rec), flush=True)
            out.append(rec)
    return out


if __name__ == "__main__":
    main()
