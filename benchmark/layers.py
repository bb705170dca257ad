"""Device times of single layers of the program, for the per-layer readers:
one f32 V-cycle, the finest f32 composite apply and the ghost-stencil kernel
alone, each read from a ``torch.profiler`` trace of single calls and, for the
last two, set against their roofline (``roofline``).

Each call runs cold: the calls rotate over input sets that together exceed
the card's L2 four times (the program's ``hbm_rotate`` rule, copied), so
that each reads its inputs from device memory, as the solve's own calls do.
The caller synchronises after each call, and a call's device time is the
union of the kernel, memcpy and memset intervals that it started
(``trace.span_busy``): the time in which the device worked on it, without
the host's launch gaps.  Every function needs a CUDA card and raises
without one."""

from __future__ import annotations

import itertools
import math
import os
import shutil
import statistics
import tempfile
from typing import Callable, Optional, Sequence

import torch

from . import roofline, trace

SPAN = "bench/layer"


def _require_card(device: torch.device) -> None:
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA card; it has no CPU fallback")


def cold_sets(set_bytes: int) -> int:
    """How many input sets of ``set_bytes`` bytes together exceed four
    times the card's L2 (at least 2)."""
    l2 = torch.cuda.get_device_properties(torch.cuda.current_device()).L2_cache_size
    return max(2, math.ceil(4 * l2 / set_bytes))


def rotated(args: Sequence[torch.Tensor]) -> list:
    """``args`` and enough copies of them to exceed the L2 four times."""
    nbytes = sum(t.numel() * t.element_size() for t in args)
    return [tuple(args)] + [tuple(t.clone() for t in args)
                            for _ in range(cold_sets(nbytes) - 1)]


def device_ms(device: torch.device, fn: Callable[..., object], args: Sequence[torch.Tensor],
              calls: int, warmup: int = 3) -> Optional[float]:
    """Median device ms of ``calls`` calls of ``fn(*args)``, cold, from the
    profiler's trace, over the calls of which it kept a record (it loses a
    few per 10,000); None where it kept none."""
    _require_card(device)
    sets = itertools.cycle(rotated(args))
    for _ in range(warmup):
        fn(*next(sets))
    torch.cuda.synchronize(device)
    from torch.profiler import ProfilerActivity

    tmp = tempfile.mkdtemp(prefix="bench-layer-")
    try:
        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                with torch.profiler.record_function(SPAN):
                    fn(*next(sets))
                torch.cuda.synchronize(device)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        busy = trace.span_busy(trace.load(path), SPAN)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    kept = [b for b in busy if b > 0.0]
    return 1e3 * statistics.median(kept) if kept else None


def _fine_f32(run):
    """The f32 finest level of the solver's V-cycle, or None."""
    gmg = getattr(run.solver, "gmg", None)
    if gmg is None or gmg.levels[0].dtype != torch.float32:
        return None
    return gmg.levels[0]


def _random(run, shape, dtype=torch.float32) -> torch.Tensor:
    g = torch.Generator(device=run.device)
    g.manual_seed(int(run.seed) % 2**63)
    return torch.randn(shape, generator=g, dtype=dtype, device=run.device)


def vcycle_ms(run) -> Optional[float]:
    """Device ms of one f32 cycle (``gmg.GMGCycle.apply``) on the finest
    residual shape."""
    if _fine_f32(run) is None:
        return None
    x = run.pool[0].to(torch.float32)
    return device_ms(run.device, run.solver.gmg.apply, (x,), calls=10)


def apply_roofline(run) -> Optional[float]:
    """The finest f32 composite apply (``ops.level_ops.Level.apply``), cold,
    as a share (%) of ``u`` read and ``A u`` written once at the card's HBM
    rate."""
    level = _fine_f32(run)
    if level is None:
        return None
    u = run.pool[0].to(torch.float32)
    ms = device_ms(run.device, level.apply, (u,), calls=30)
    if ms is None:
        return None
    bw, _ = roofline.card(torch.cuda.get_device_name(run.device))
    bound_s = roofline.apply_bytes(u.numel(), 4) / bw
    return roofline.share_pct(bound_s, ms * 1e-3)


def stencil_roofline(run) -> Optional[float]:
    """The ghost-stencil kernel alone (``ops.ghost_stencil``) at the finest
    shape in f32, cold, as a share (%) of the larger of its byte and flop
    bounds."""
    from pressurepoissonsolver_torch.ops import ghost_stencil as gs

    level = _fine_f32(run)
    if level is None:
        return None
    D, n, P = run.D, run.n, len(run.starts)
    kernel = gs.ghost_stencil if D == 2 else gs.ghost_stencil_3d
    args = (_random(run, (P,) + (n,) * D), _random(run, (P, 2 * D, n ** (D - 1))),
            level.ghost_coef_eff.to(torch.float32).contiguous(),
            level.h2inv.to(torch.float32).contiguous())
    ms = device_ms(run.device, kernel, args, calls=30)
    if ms is None:
        return None
    bw, peaks = roofline.card(torch.cuda.get_device_name(run.device))
    bound_s, _ = roofline.stencil_bound_s(D, P, n, torch.float32, bw, peaks)
    return roofline.share_pct(bound_s, ms * 1e-3)
