"""Device timing with CUDA events.

PyTorch returns before the device finishes, so a host clock without a
synchronise measures the enqueue.  :func:`cuda_median_ms` brackets each
call with a pair of CUDA events on the current stream and reads them after
one synchronise at the end.

When the host needs longer to enqueue a call than the device needs to run
it, the events measure the host's pace (the device idles between them).
``hold=True`` first parks the stream on a sleep kernel long enough for the
host to enqueue every call; the calls then run back to back and the events
measure device time alone.  ``fn`` must not synchronise.

Back-to-back calls on the same tensors find them in the 50 MB L2 when they
fit.  :func:`cold_median_ms` rotates the calls over several input sets, so
that each call finds its inputs evicted, as a caller that streams the field
from device memory would.
"""

from __future__ import annotations

import itertools
import math
import statistics
from typing import Callable, Sequence

import torch

# sleep-kernel length for ``hold`` (clock cycles; ~0.1 s on an H100)
HOLD_CYCLES = 200_000_000


def cuda_median_ms(fn: Callable[[], object], reps: int = 20, warmup: int = 3,
                   hold: bool = False) -> float:
    """Median device milliseconds of ``reps`` calls of ``fn``, each
    bracketed by CUDA events, after ``warmup`` untimed calls.  Raises
    without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_median_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


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
