"""Profiling and tracing: program spans, device stamps, profiler traces, op
timing and the op report.

Port of ``pressurepoissonsolver_tpu.utils.profiling``, with the port's own
spans:

* :func:`span` — a named region of the program, named
  ``pps.<module>.<what>``.  Off (the default) it is one flag test and a
  shared null context.  :func:`enable` turns on host spans: each records
  ``(name, parent, solve, t0_ns, t1_ns, bytes)`` in memory
  (:func:`host_spans`; ``perf_counter_ns`` times, ``bytes`` the change of
  ``torch.cuda.memory_allocated()``), and while a ``torch.profiler``
  session runs it also opens a ``record_function`` of its name, so that it
  shows in the exported trace.  :func:`device_spans` turns on device
  stamps: a span then also launches a stamp kernel (``csrc/graph_loop.cu``,
  ``pps_stamp``) on the current stream at its entry and at its exit; a
  stamp launched while a piece is captured (``utils.graphs.capture``) is a
  node of the piece, so a one-launch solve captured under
  :func:`device_spans` times its layers on the device, inside WHILE bodies
  too, where the profiler records no kernel.  On the CPU the same spans
  write ``perf_counter_ns`` into the same buffer format.  The buffer is read
  once, when the :func:`device_spans` block ends (:class:`DeviceRecord`:
  the spans with their parent, solve and self time, and the stamps past its
  capacity, counted, never dropped silently).  :func:`device_clock_offset`
  pairs the device's clock with a profiler trace's, and :func:`trace` then
  writes the device spans into the trace it exports, as their own track;
* :func:`trace` — a ``torch.profiler`` trace of a code block (host spans on)
  written into a directory;
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
import functools
import itertools
import json
import math
import os
import subprocess
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

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


# -- spans and device stamps -------------------------------------------------


class SpanRecord(NamedTuple):
    """A host span (:func:`enable`)."""

    name: str
    parent: int  # its enclosing span's index in host_spans(), -1 at the top
    solve: int  # the solve it ran in (the n-th ``solve=True`` span), -1 outside
    t0_ns: int  # time.perf_counter_ns() at its entry
    t1_ns: int  # and at its exit
    bytes: int  # the change of torch.cuda.memory_allocated() across it


class DeviceSpan(NamedTuple):
    """A span on the device, from its entry and exit stamps."""

    name: str
    parent: int  # its enclosing span's index in DeviceRecord.spans(), -1 at the top
    solve: int  # the solve it ran in, -1 outside any
    t0_ns: int  # the device's clock (%globaltimer; perf_counter_ns on the CPU)
    t1_ns: int
    self_ns: int  # its duration less what its child spans cover


#: entries of a stamp buffer (16 bytes each: 4 MB)
STAMP_CAPACITY = 1 << 18
#: the name of the clock stamps (:func:`device_clock_offset`), index 0 of the
#: stamps' name table, and the name of their kernel in a profiler trace
CLOCK = "pps.profiling.clock"
CLOCK_KERNEL = "pps_stamp_clock"
#: the process id of the device-span track that :func:`trace` adds
DEVICE_TRACK_PID = 0x7073

_NULL = contextlib.nullcontext()
# host spans or device stamps on: the one flag span() tests
_active = False
# the stamps' name table (a stamp's id is 2 * index, + 1 at a span's exit)
_names: List[str] = [CLOCK]
_ids: Dict[str, int] = {CLOCK: 0}
_solve_names: set = set()


class _State:
    def __init__(self):
        self.host = False  # host spans on
        self.stamps = None  # the stamp buffer (_Buffer), while on
        self.records: list = []  # host spans, in the order they opened
        self.stack: list = []  # the open host spans' indices
        self.solves = 0  # solve spans opened so far
        self.solve = -1  # the solve now running
        self.clocks = 0  # clock stamps launched so far
        self.traced: Optional[list] = None  # records closed inside trace()


_state = _State()
_buffers: dict = {}


def _refresh() -> None:
    global _active
    _active = _state.host or _state.stamps is not None


def _allocated() -> int:
    return torch.cuda.memory_allocated() if torch.cuda.is_initialized() else 0


def _id(name: str, solve: bool = False) -> int:
    i = _ids.get(name)
    if i is None:
        i = _ids[name] = len(_names)
        _names.append(name)
    if solve:
        _solve_names.add(name)
    return i


class _Buffer:
    """The stamp buffer of one device: ``[STAMP_CAPACITY, 2]`` int64 (id,
    time in ns) and a cursor, the number of stamps taken.  Made once per
    device and kept: a captured stamp holds its address."""

    def __init__(self, device: torch.device):
        self.device = device
        self.buf = torch.zeros((STAMP_CAPACITY, 2), dtype=torch.int64, device=device)
        if device.type == "cuda":
            from . import graphs

            graphs.build()
            self._call = graphs._call
            self.cursor = torch.zeros(1, dtype=torch.int64, device=device)
        else:
            self.host = self.buf.numpy()
            self.count = 0

    def reset(self) -> None:
        if self.device.type == "cuda":
            self.cursor.zero_()
        else:
            self.count = 0

    def stamp(self, ident: int, clock: bool = False) -> None:
        if self.device.type == "cuda":
            self._call("pps_stamp_launch", ident, self.buf.data_ptr(), self.cursor.data_ptr(),
                       STAMP_CAPACITY, int(clock),
                       torch.cuda.current_stream(self.device).cuda_stream)
            return
        i = self.count
        self.count += 1
        if i < STAMP_CAPACITY:
            self.host[i, 0] = ident
            self.host[i, 1] = time.perf_counter_ns()

    def read(self) -> Tuple[np.ndarray, int]:
        """The entries kept and the stamps taken (one synchronise and one
        read on the card)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            taken = int(self.cursor.item())
            return self.buf[:min(taken, STAMP_CAPACITY)].cpu().numpy(), taken
        return self.host[:min(self.count, STAMP_CAPACITY)].copy(), self.count


class _Span:
    __slots__ = ("name", "solve", "device", "stamps", "index", "outer", "rf", "m0", "t0")

    def __init__(self, name: str, solve: bool, device: bool):
        self.name, self.solve, self.device = name, solve, device

    def __enter__(self):
        st = _state
        self.stamps = st.stamps if self.device else None
        if self.stamps is not None:
            self.stamps.stamp(2 * _id(self.name, self.solve))
        self.index = -1
        if st.host:
            self.outer = st.solve
            if self.solve:
                st.solve, st.solves = st.solves, st.solves + 1
            self.index = len(st.records)
            st.records.append(None)
            st.stack.append(self.index)
            # the memory read (a call of a few hundred µs) stays outside the
            # span's times and its record in a trace
            self.m0 = _allocated()
            self.rf = None
            if torch.autograd._profiler_enabled():
                self.rf = torch.profiler.record_function(self.name)
                self.rf.__enter__()
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        st = _state
        if self.index >= 0:
            t1 = time.perf_counter_ns()
            if self.rf is not None:
                self.rf.__exit__(*exc)
            st.stack.pop()
            parent = st.stack[-1] if st.stack else -1
            st.records[self.index] = SpanRecord(self.name, parent, st.solve, self.t0, t1,
                                                _allocated() - self.m0)
            st.solve = self.outer
        if self.stamps is not None:
            self.stamps.stamp(2 * _ids[self.name] + 1)
        return False


def span(name: str, *, solve: bool = False, device: bool = True):
    """The span ``name`` as a context manager (module docstring).  ``solve``:
    the span is one solve, whose id the spans inside it carry;
    ``device=False``: host only, never stamped (set-up, the sharded path)."""
    if not _active:
        return _NULL
    return _Span(name, solve, device)


def spanned(name: str, *, solve: bool = False, device: bool = True):
    """A decorator: each call of the function in :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, solve=solve, device=device):
                return fn(*args, **kwargs)

        return call

    return wrap


def enable() -> None:
    """Host spans on (:func:`host_spans`)."""
    _state.host = True
    _refresh()


def disable() -> None:
    """Host spans off; the spans recorded stay until :func:`clear`."""
    _state.host = False
    _refresh()


def host_spans() -> List[SpanRecord]:
    """The host spans recorded since :func:`clear`, in the order they
    opened; a span still open is left out, its index kept."""
    return [r for r in _state.records if r is not None]


def clear() -> None:
    """Forget the host spans recorded (call it outside any open span)."""
    _state.records, _state.stack = [], []
    _state.solves, _state.solve = 0, -1


def device_spans_on() -> bool:
    """Whether spans stamp the device (inside :func:`device_spans`): a
    piece captured now holds stamp nodes."""
    return _state.stamps is not None


def _device(device) -> torch.device:
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@contextlib.contextmanager
def device_spans(device=None):
    """Device stamps on ``device`` (the card where there is one) for the
    block: every span stamps its entry and exit on the device's current
    stream (on the CPU, ``perf_counter_ns`` into the same buffer).  The
    buffer's cursor is reset at the start; under an active
    ``torch.profiler`` session a clock stamp (:func:`device_clock_offset`)
    is taken at the start and at the end.  Yields a :class:`DeviceRecord`,
    filled when the block ends, with one synchronise and one read."""
    if _state.stamps is not None:
        raise RuntimeError("device_spans is already on")
    dev = _device(device)
    buf = _buffers.get(dev)
    if buf is None:
        buf = _buffers[dev] = _Buffer(dev)
    buf.reset()
    rec = DeviceRecord(dev)
    _state.stamps = buf
    _refresh()
    clock = torch.autograd._profiler_enabled()
    try:
        if clock:
            rec.clock_ordinals.append(device_clock_offset())
        yield rec
        if clock:
            rec.clock_ordinals.append(device_clock_offset())
    finally:
        _state.stamps = None
        _refresh()
        rec.entries, rec.taken = buf.read()
        if _state.traced is not None:
            _state.traced.append(rec)


def device_clock_offset() -> int:
    """Launch a clock stamp now, eagerly, under device stamps (on the card a
    kernel of its own name, :data:`CLOCK_KERNEL`, whose profiler record
    gives its start on the trace's clock; on the CPU a ``record_function``
    of :data:`CLOCK` around the stamp).  Its ordinal among the clock stamps
    of this process; :meth:`DeviceRecord.clock_offsets` pairs the stamps
    with their records in the exported trace, which gives the offset of the
    device's clock from the trace's, and two of them its drift."""
    buf = _state.stamps
    if buf is None:
        raise RuntimeError("device_clock_offset needs device_spans on")
    if buf.device.type == "cuda":
        buf.stamp(0, clock=True)
    else:
        with torch.profiler.record_function(CLOCK):
            buf.stamp(0, clock=True)
    _state.clocks += 1
    return _state.clocks - 1


class DeviceRecord:
    """The stamps of one :func:`device_spans` block: ``entries`` (id, ns)
    in the order they were taken, ``taken`` (all the stamps, kept or not),
    ``overflow`` (those past the capacity: a record with any is truncated,
    and :meth:`spans` refuses it)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.entries = np.zeros((0, 2), dtype=np.int64)
        self.taken = 0
        self.capacity = STAMP_CAPACITY
        self.clock_ordinals: List[int] = []

    @property
    def overflow(self) -> int:
        return max(0, self.taken - self.capacity)

    def clocks(self) -> List[int]:
        """The times of the clock stamps."""
        return [t for ident, t in self.entries.tolist() if ident >> 1 == 0]

    def spans(self) -> List[DeviceSpan]:
        """The spans, matched entry to exit in the order of the stamps (one
        stream runs them in order), each with its parent, solve and self
        time.  Raises on a truncated record or a stamp without its pair."""
        if self.overflow:
            raise ValueError(f"the record is truncated: {self.overflow} stamps past "
                             f"its capacity of {self.capacity}")
        out: list = []
        stack: list = []
        solves = 0
        for ident, t in self.entries.tolist():
            index, end = ident >> 1, ident & 1
            if index == 0:
                continue  # a clock stamp
            name = _names[index]
            if not end:
                parent = stack[-1] if stack else -1
                if parent >= 0:
                    solve = out[parent][2]
                elif name in _solve_names:
                    solve, solves = solves, solves + 1
                else:
                    solve = -1
                stack.append(len(out))
                out.append([name, parent, solve, t, None, 0])
                continue
            if not stack or out[stack[-1]][0] != name:
                raise ValueError(f"an exit stamp of {name!r} without its entry")
            i = stack.pop()
            out[i][4] = t
            if out[i][1] >= 0:
                out[out[i][1]][5] += t - out[i][3]
        if stack:
            raise ValueError(f"{len(stack)} spans without their exit stamp")
        return [DeviceSpan(n, p, s, a, b, b - a - c) for n, p, s, a, b, c in out]

    def clock_offsets(self, events: List[dict], first: Optional[int] = None):
        """Per clock stamp of this record: the device's clock less the
        trace's (ns), from its record among ``events`` (an exported trace's
        ``traceEvents``) whose clock stamps start at ordinal ``first``
        (default: this record's first).  ``None`` where the trace does not
        hold every one of them."""
        clocks = self.clocks()
        if not self.clock_ordinals or len(clocks) != len(self.clock_ordinals):
            return None
        if self.device.type == "cuda":
            recs = [e for e in events if e.get("ph") == "X" and e.get("name") == CLOCK_KERNEL
                    and str(e.get("cat", "")).lower() == "kernel"]
        else:
            recs = [e for e in events if e.get("ph") == "X" and e.get("name") == CLOCK
                    and e.get("cat") == "user_annotation"]
        starts = sorted(float(e["ts"]) for e in recs)
        first = self.clock_ordinals[0] if first is None else first
        at = [k - first for k in self.clock_ordinals]
        if min(at) < 0 or max(at) >= len(starts):
            return None
        return [c - 1e3 * starts[k] for c, k in zip(clocks, at)]

    def trace_us(self, t_ns: float, offsets: List[float]) -> float:
        """A device time on the trace's clock (µs), through the clock
        offsets (interpolated between the first and the last)."""
        clocks = self.clocks()
        off = offsets[0]
        if len(offsets) > 1 and clocks[-1] > clocks[0]:
            w = min(max((t_ns - clocks[0]) / (clocks[-1] - clocks[0]), 0.0), 1.0)
            off = offsets[0] + w * (offsets[-1] - offsets[0])
        return (t_ns - off) * 1e-3


def stamp_resolution_ns(device=None, reads: int = 4096) -> dict:
    """How finely the stamps' clock ticks on ``device``: one thread reads it
    ``reads`` times back to back (on the card ``pps_timer_probe``,
    ``%globaltimer``; on the CPU ``perf_counter_ns``).  The smallest and the
    median nonzero step between two reads, the distinct values and the span
    of the reads (ns)."""
    dev = _device(device)
    if dev.type == "cuda":
        from . import graphs

        out = torch.zeros(reads, dtype=torch.int64, device=dev)
        graphs._call("pps_timer_probe_launch", out.data_ptr(), reads,
                     torch.cuda.current_stream(dev).cuda_stream)
        values = out.cpu().numpy()
    else:
        values = np.array([time.perf_counter_ns() for _ in range(reads)], dtype=np.int64)
    steps = np.diff(values)
    steps = steps[steps > 0]
    return {"min_step_ns": int(steps.min()) if steps.size else None,
            "median_step_ns": float(np.median(steps)) if steps.size else None,
            "distinct": int(np.unique(values).size),
            "span_ns": int(values[-1] - values[0])}


def add_device_track(path: str, records: List[DeviceRecord], first: int = 0) -> int:
    """Write the device spans of ``records`` into the Chrome trace at
    ``path``, on the trace's clock (:meth:`DeviceRecord.clock_offsets`, the
    trace's clock stamps starting at ordinal ``first``), as a track of
    their own (process :data:`DEVICE_TRACK_PID`, "pps device spans").  The
    spans written; none from a record without its clock stamps in the
    trace."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    added = []
    for rec in records:
        offsets = rec.clock_offsets(events, first)
        if offsets is None:
            continue
        for sp in rec.spans():
            t0, t1 = rec.trace_us(sp.t0_ns, offsets), rec.trace_us(sp.t1_ns, offsets)
            added.append({"ph": "X", "cat": "pps_device_span", "name": sp.name,
                          "pid": DEVICE_TRACK_PID, "tid": 0, "ts": t0, "dur": t1 - t0,
                          "args": {"solve": sp.solve, "self_us": sp.self_ns * 1e-3}})
    if added:
        events.append({"ph": "M", "name": "process_name", "pid": DEVICE_TRACK_PID, "tid": 0,
                       "args": {"name": "pps device spans"}})
        events.extend(added)
        with open(path, "w") as f:
            json.dump(data, f)
    return len(added)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a code block (CPU, and CUDA when there is a card), host spans
    on, and write its trace into ``logdir`` as ``trace.json``
    (Chrome/Perfetto); the device spans of every :func:`device_spans`
    block inside it are added as a track of their own
    (:func:`add_device_track`)::

        with profiling.trace("build/trace"), profiling.device_spans():
            solver.solve_refined(f)
    """
    from torch.profiler import profile

    os.makedirs(logdir, exist_ok=True)
    host, outer, first = _state.host, _state.traced, _state.clocks
    _state.traced = records = []
    try:
        with profile(activities=_activities()) as prof:
            enable()
            try:
                yield logdir
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            finally:
                _state.host = host
                _refresh()
    finally:
        _state.traced = outer
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    if records:
        add_device_track(path, records, first)

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
