"""Device timing with CUDA events, and the CLI's named-section timer.

:class:`Timer` is the reference's ``Tools::Timer`` (``Timer.h:32-89``):
named wall-clock sections that accumulate over repeats and pretty-print.
The reference synchronises ranks with ``MPI_Barrier`` at start and stop;
here the timer synchronises its CUDA device instead, so that sections bound
device work, not its enqueue.

PyTorch returns before the device finishes, so a host clock without a
synchronise measures the enqueue.  :func:`cuda_median_ms` brackets each
call with a pair of CUDA events on the current stream and reads them after
one synchronise at the end.

When the host needs longer to enqueue a call than the device needs to run
it, the events measure the host's pace (the device idles between them).
``hold=True`` first parks the stream on a sleep kernel long enough for the
host to enqueue every call; the calls then run back to back and the events
measure device time alone.  ``fn`` must not synchronise.  A held timing
checks that the hold outlasted the enqueue and takes fewer calls under a
longer hold when it did not.

Back-to-back calls on the same tensors find them in the 50 MB L2 when they
fit.  :func:`cold_median_ms` rotates the calls over several input sets, so
that each call finds its inputs evicted, as a caller that streams the field
from device memory would.
"""

from __future__ import annotations

import itertools
import math
import statistics
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Sequence

import torch

# sleep-kernel length for ``hold`` (clock cycles; ~0.1 s on an H100), and
# the longest hold a retry takes (~1.6 s)
HOLD_CYCLES = 200_000_000
HOLD_MAX_CYCLES = 16 * HOLD_CYCLES


class Timer:
    """Named wall-clock sections; ``device``: a device synchronised at
    every start and stop when it is a CUDA device (no barrier otherwise)."""

    def __init__(self, device=None):
        self._sections: "OrderedDict[str, List[float]]" = OrderedDict()
        self._open: Dict[str, float] = {}
        self._sync = device is not None and torch.device(device).type == "cuda"
        self._device = device

    def _barrier(self):
        if self._sync:
            torch.cuda.synchronize(self._device)

    def start(self, name: str) -> None:
        self._barrier()
        self._open[name] = time.time()

    def stop(self, name: str) -> None:
        self._barrier()
        t = time.time() - self._open.pop(name)
        self._sections.setdefault(name, []).append(t)

    def __getitem__(self, name: str) -> float:
        return sum(self._sections.get(name, [0.0]))

    class _Section:
        def __init__(self, timer, name):
            self.timer, self.name = timer, name

        def __enter__(self):
            self.timer.start(self.name)

        def __exit__(self, *exc):
            self.timer.stop(self.name)

    def section(self, name: str) -> "Timer._Section":
        return Timer._Section(self, name)

    def report(self) -> str:
        lines = ["", "TIMING RESULTS", "=" * 50, ""]
        for name, times in self._sections.items():
            if len(times) == 1:
                lines.append(f"{name}")
                lines.append("-" * len(name))
                lines.append(f"   time (sec): {times[0]:.6f}")
            else:
                lines.append(f"{name} ({len(times)} repeats)")
                lines.append("-" * len(name))
                lines.append(f"  total (sec): {sum(times):.6f}")
                lines.append(f"   avg  (sec): {sum(times)/len(times):.6f}")
            lines.append("")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.report()


class HostPaced(RuntimeError):
    """The host could not queue even one call of a held timing before the
    hold ran out, so no device time could be taken with events."""


def cuda_median_ms(fn: Callable[[], object], reps: int = 20, warmup: int = 3,
                   hold: bool = False) -> float:
    """Median device milliseconds of ``reps`` calls of ``fn``, each
    bracketed by CUDA events, after ``warmup`` untimed calls.  Raises
    without a CUDA device.

    With ``hold``, an event recorded right after the sleep kernel tells
    whether the sleep was still running when the last call had been queued;
    if it was not (the enqueue outlasted the hold, or the launch queue
    filled and blocked the host), the calls may have run at the host's
    pace, and the timing is taken again with a quarter of the calls and
    four times the hold, down to one call under ``HOLD_MAX_CYCLES``.  When
    even that fails it raises :class:`HostPaced`: a held time is device
    time or nothing."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_median_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = HOLD_CYCLES
    while True:
        held = None
        if hold:
            torch.cuda._sleep(cycles)
            held = torch.cuda.Event()
            held.record()
        pairs = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        covered = held is None or not held.query()
        torch.cuda.synchronize()
        if covered:
            return statistics.median(s.elapsed_time(e) for s, e in pairs)
        if reps == 1 and cycles >= HOLD_MAX_CYCLES:
            raise HostPaced(f"one call outlasted a hold of {cycles} cycles")
        reps = max(1, reps // 4)
        cycles = min(4 * cycles, HOLD_MAX_CYCLES)


def cold_sets(set_bytes: int) -> int:
    """How many input sets of ``set_bytes`` bytes together exceed four times
    the card's L2 (at least 2)."""
    l2 = torch.cuda.get_device_properties(torch.cuda.current_device()).L2_cache_size
    return max(2, math.ceil(4 * l2 / set_bytes))


def cold_median_ms(fn: Callable[..., object], arg_sets: Sequence[Sequence],
                   reps: int = 50, warmup: int = 3) -> float:
    """Device time (held stream) of ``fn(*args)`` with ``args`` rotating
    over ``arg_sets``: when the sets together exceed the L2 several times,
    each call reads its inputs from device memory."""
    it = itertools.cycle(arg_sets)
    return cuda_median_ms(lambda: fn(*next(it)), reps=reps, warmup=warmup, hold=True)
