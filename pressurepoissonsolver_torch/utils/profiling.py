"""Profiling and tracing: profiler traces, op timing and the op report.

Port of ``pressurepoissonsolver_tpu.utils.profiling``:

* :func:`trace` / :func:`annotate` — a ``torch.profiler`` trace of a code
  block written into a directory, and a named region in it;
* :func:`time_op` — seconds per call of an op.  On a CUDA tensor with
  ``in_graph=True`` it is device time: CUDA events on a stream held by a
  sleep kernel until every call is queued (``timer.cuda_median_ms(...,
  hold=True)``), the counterpart of the reference's calibrated in-graph
  loop, which takes the host's cost out; without ``in_graph``, the
  synchronised wall of back-to-back calls (the host's pace);
* :func:`op_report` — the per-op table of a ``Level`` (``interpolate``,
  ``apply``, ``patch_solve``, ``smooth``) with each op's share of the
  memory-rate bound.

Each row says how it was timed (:func:`measure`'s labels):

* ``held_stream_device`` — device time, stream held;
* ``profiler_device_busy`` — the op queues more work than a hold can cover
  (thousands of launches: the launch queue fills and blocks the host), so
  its time is the sum of its kernels' device times in a ``torch.profiler``
  run: device time without the idle gaps;
* ``synchronised_wall`` — best wall per call of back-to-back calls ending
  in a synchronise (the op reads the host, or ``in_graph`` is off);
* ``cpu_wall`` — a CPU tensor: best wall per call, nothing synchronised.

The reference feeds each output back as the next input; here every call
takes the same inputs (or rotated copies), since repeated applications of
the operator overflow f32 within a few calls.

``python -m pressurepoissonsolver_torch.scripts.profile_ops`` is the
command-line report.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import subprocess
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from . import timer

#: device-memory rate per card name (``torch.cuda.get_device_name``), bytes/s:
#: the H100 SXM's data-sheet rate; ``cpu`` is the reference's nominal rate
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "cpu": 50e9,
}


def _device_bw(device="cuda") -> float:
    """The memory rate of ``device`` from :data:`HBM_BYTES_PER_S`; raises
    for a CUDA card not in the table (no guess)."""
    device = torch.device(device)
    if device.type == "cpu":
        return HBM_BYTES_PER_S["cpu"]
    name = torch.cuda.get_device_name(device)
    if name not in HBM_BYTES_PER_S:
        raise ValueError(f"no memory rate for {name!r} in HBM_BYTES_PER_S: add "
                         "the card's data-sheet rate")
    return HBM_BYTES_PER_S[name]


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a code block (CPU, and CUDA when there is a card) and write
    its trace into ``logdir`` as ``trace.json`` (Chrome/Perfetto)::

        with profiling.trace("build/trace"):
            solver.solve(f)
    """
    from torch.profiler import profile

    os.makedirs(logdir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named region of a trace."""
    return torch.profiler.record_function(name)


def kernel_times(prof) -> List[Tuple[float, int, str]]:
    """``(device µs, count, name)`` of every device row of a finished
    ``torch.profiler.profile``."""
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            rows.append((float(us), int(e.count), e.key))
    return rows


def _profiled_busy_s(fn: Callable, args, calls: int = 3) -> float:
    """Device seconds per call of ``fn(*args)``: its kernels' device time
    summed over ``calls`` profiled calls (after one unprofiled)."""
    from torch.profiler import profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=_activities()) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    busy_us = sum(r[0] for r in kernel_times(prof))
    return busy_us * 1e-6 / calls if busy_us > 0 else float("nan")


def _wall_s(fn: Callable, arg_sets, reps: int, trials: int, sync: bool) -> float:
    it = itertools.cycle(arg_sets)
    fn(*next(it))
    best = math.inf
    for _ in range(max(trials, 1)):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*next(it))
        if sync:
            torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best / reps if best > 0 else float("nan")


def measure(fn: Callable, *args, reps: int = 200, in_graph: bool = False,
            trials: int = 3, hbm_rotate: int = 0) -> Tuple[float, str]:
    """``(seconds per call of fn(*args), how it was timed)``; the labels
    are in the module docstring.  NaN seconds: no measurement.

    ``hbm_rotate=B`` rotates the calls over ``B`` copies of the first
    argument, so that with ``B`` copies beyond the L2 each call reads its
    input from device memory.  ``trials`` takes the best of that many
    walls (a held timing is already the median of ``reps`` calls)."""
    arg_sets = [args]
    if hbm_rotate > 1:
        arg_sets += [(args[0].clone(), *args[1:]) for _ in range(hbm_rotate - 1)]
    if args[0].device.type != "cuda":
        return _wall_s(fn, arg_sets, reps, trials, sync=False), "cpu_wall"
    if not in_graph:
        return _wall_s(fn, arg_sets, reps, trials, sync=True), "synchronised_wall"
    try:
        return timer.cold_median_ms(fn, arg_sets, reps=reps) * 1e-3, "held_stream_device"
    except timer.HostPaced:
        return _profiled_busy_s(fn, args), "profiler_device_busy"


def time_op(fn: Callable, *args, reps: int = 200, in_graph: bool = False,
            trials: int = 3, hbm_rotate: int = 0) -> float:
    """Seconds per call of ``fn(*args)`` (:func:`measure` without its
    label)."""
    return measure(fn, *args, reps=reps, in_graph=in_graph, trials=trials,
                   hbm_rotate=hbm_rotate)[0]


def sig4(x: float) -> float:
    """``x`` to 4 significant figures (a nonzero share never reads 0)."""
    return float(f"{x:.4g}")


def timed_row(fn: Callable, args, bytes_needed: float, bw: float, reps: int,
              nnz: int = 0, in_graph: bool = True, hbm_rotate: int = 0) -> dict:
    """One report row: device ms, the share of the memory-rate bound for
    ``bytes_needed`` at ``bw`` bytes/s, how it was timed, and for ``nnz``
    stencil nonzeros the rate in Gnnz/s."""
    t, how = measure(fn, *args, reps=reps, in_graph=in_graph, hbm_rotate=hbm_rotate)
    row = {"ms": t * 1e3, "roofline_pct": sig4(100 * bytes_needed / bw / t),
           "timing": how}
    if nnz:
        row["gnnz_per_s"] = sig4(nnz / t / 1e9)
    if hbm_rotate:
        row["rotation_buffers"] = hbm_rotate
    return row


def rotation_buffers(device, field_bytes: int) -> int:
    """Copies of a field that together exceed the L2 four times on a card
    (``timer.cold_sets``); 2 on the CPU."""
    return timer.cold_sets(field_bytes) if torch.device(device).type == "cuda" else 2


def random_field(level, rng) -> torch.Tensor:
    """A seeded ``[P, *ns]`` field on the level's device, in its dtype."""
    return torch.as_tensor(rng.standard_normal((level.P,) + level.pl.ns_shape),
                           dtype=level.dtype, device=level.device)


def op_report(level, reps: int = 20, hbm_force: bool = False) -> Dict[str, dict]:
    """Timing and roofline table of a ``Level``'s core ops.

    Roofline bytes are the traffic the op needs (read the input field
    once, write the output once); intermediates count against the share.
    ``hbm_force=True`` adds an ``<op>_hbm`` row per op with the calls
    rotating over copies of the input that exceed the L2 four times, so the
    input comes from device memory each call.  With ``patch_solver="bcgs"``
    the patch solve reads the host every iteration, so ``patch_solve`` and
    ``smooth`` are synchronised walls."""
    bw = _device_bw(level.device)
    itemsize = torch.empty((), dtype=level.dtype).element_size()
    cells = level.P * level.pl.cells_per_patch
    field_bytes = cells * itemsize
    rng = np.random.default_rng(0)
    u = random_field(level, rng)
    g = torch.as_tensor(rng.standard_normal((max(level.num_ifaces, 1), level.m)),
                        dtype=level.dtype, device=level.device)
    nnz = (2 * level.D + 1) * cells
    held = level.patch_solver_kind != "bcgs"
    B = rotation_buffers(level.device, field_bytes) if hbm_force else 0

    out: Dict[str, dict] = {}
    for name, fn, nbytes, nz, in_graph in (
        ("interpolate", level.interpolate, 2 * field_bytes, 0, True),
        ("apply", level.apply, 2 * field_bytes, nnz, True),
        ("patch_solve", lambda x: level.patch_solve(x, g), 2 * field_bytes, 0, held),
        ("smooth", lambda x: level.smooth(x, x), 3 * field_bytes, 0, held),
    ):
        out[name] = timed_row(fn, (u,), nbytes, bw, reps, nz, in_graph)
        if B:
            out[name + "_hbm"] = timed_row(fn, (u,), nbytes, bw, reps, 0, in_graph, B)
    return out
