"""Solve loops run on the card: captured pieces composed into one CUDA graph
with WHILE nodes.

The reference compiles each solve into one XLA program (``jax.jit``
around a ``lax.while_loop``): a solve is one device dispatch, and its stop
tests stay on the device.  The counterpart on one CUDA card is
:class:`GraphLoop`.  A solve is a program (``krylov.While``): an init, then
pieces (device work only: the preconditioner, the operator applies, the
dots and axpys, the step counts and stop tests) and loops over a guard flag
of the state.  Each piece is captured once into a ``torch.cuda.CUDAGraph``
(:func:`capture`) over static copies of the state; the graphs are then
composed, through ``csrc/graph_loop.cu``, into one graph whose loops are
WHILE nodes: a guard kernel ahead of each WHILE node and one at the end of
its body copy the loop's flag into the node's condition and count the
passes.  A run is one graph launch; the host reads nothing until the
caller asks for the counts.  Loops nest (the refinement's rounds around
the inner Krylov loop, GMRES's cycles around its Arnoldi steps), and a loop
may run inside a piece (:class:`PieceLoop`: the batched patch BiCGStab in
each smoothing of a V-cycle): its pass is captured on its own, and the
piece is cut there, its parts and the loop taking its place, since the
CUDA driver does not clone a captured graph that holds a WHILE node into
another graph.

The plain version of the WHILE node is ``krylov.run_loop``: the same
pieces replayed one by one, each loop's guard read to the host before
every pass (:meth:`GraphLoop.replay`).  The CPU takes it (with an
emulation of :func:`capture`, in the tests), and so does the per-step
replay kept for comparison on the card.  A conditional node that the
driver refuses, or a build that fails, raises; there is no fallback.

Inputs (the right-hand side, ``tol``, the step limits) are static buffers
copied in before a run, so no new value needs a new capture.  Results are
fresh tensors, never views of the graph's buffers.  The kernels' wrappers
count their launches on the host (``utils.counters``), where a graph does
not pass: the counts of each piece are recorded at capture, by table name,
and added per replay, or, after a graph launch, times the passes the
launch made (read with the results, or later by ``counters.flush``).
``launches`` counts
the guard kernel's runs, the WHILE-node passes and the graph launches,
and ``nodes`` the device nodes that ran (each piece's kernel, memcpy and
memset nodes, counted at its capture with :func:`count_nodes`, times its
passes; in a launch also the guard kernels and the memset that zeroes the
pass counters); ``inner`` the passes and runs of the loops inside pieces,
in every mode.

Each captured piece is the device span ``pps.graphs.piece.<label>``
(``utils.profiling``; the label is the piece function's name, ``.1``,
``.2``, ... on the parts after a cut), stamped as its first and last node
when it is captured under ``profiling.device_spans``: the gaps between two
pieces are then the WHILE guards and the child-graph transitions.  The
host spans ``pps.graphs.capture`` (a program's pieces captured),
``pps.graphs.build`` (composed and instantiated), ``pps.graphs.launch``
and ``pps.graphs.replay`` time the set-up and the runs on the host.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import time
import weakref
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import cuda_build
from ..krylov import (KrylovLoop, KrylovResult, While, _scalar, host_read, program,
                      read_flag)
from . import counters, profiling
from .profiling import span

#: ``guard``: runs of the guard kernel (one ahead of each entry of a WHILE
#: node, one per pass); ``passes``: WHILE-node passes; ``graph``: graph
#: launches of whole solves; ``nodes``: device nodes run (module docstring)
launches = {"guard": 0, "passes": 0, "graph": 0, "nodes": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for counts in (launches, inner):
        for k in counts:
            counts[k] = 0


def build() -> ctypes.CDLL:
    """Compile (at first use) and load ``csrc/graph_loop.cu``."""
    global _lib
    if _lib is None:
        lib = cuda_build.load_library("graph_loop")
        vp, pp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        sig = {
            "pps_graph_create": [pp],
            "pps_graph_add_zero": [vp, vp, vp, ctypes.c_int, pp],
            "pps_graph_add_child": [vp, vp, vp, pp],
            "pps_graph_add_while": [vp, vp, vp, vp, pp, pp,
                                    ctypes.POINTER(ctypes.c_ulonglong)],
            "pps_graph_add_guard": [vp, vp, ctypes.c_ulonglong, vp, vp, pp],
            "pps_capture_add_while": [vp, vp, vp, vp, pp, pp],
            "pps_graph_instantiate": [vp, pp],
            "pps_graph_launch": [vp, vp],
            "pps_graph_destroy": [vp, vp],
            "pps_graph_driver_version": [ctypes.POINTER(ctypes.c_int)],
            "pps_graph_runtime_version": [ctypes.POINTER(ctypes.c_int)],
            "pps_graph_count_nodes": [vp, vp],
            "pps_stamp_launch": [ctypes.c_ulonglong, vp, vp, ctypes.c_ulonglong,
                                 ctypes.c_int, vp],
            "pps_timer_probe_launch": [vp, ctypes.c_int, vp],
        }
        for name, args in sig.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.pps_graph_error_string.argtypes = [ctypes.c_int]
        lib.pps_graph_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _call(fn: str, *args) -> None:
    rc = getattr(build(), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {rc} "
                           f"({_lib.pps_graph_error_string(rc).decode()})")


def cuda_versions() -> tuple:
    """``(cudaDriverGetVersion, cudaRuntimeGetVersion)`` as the library
    sees them."""
    d, r = ctypes.c_int(0), ctypes.c_int(0)
    _call("pps_graph_driver_version", ctypes.byref(d))
    _call("pps_graph_runtime_version", ctypes.byref(r))
    return d.value, r.value


def count_nodes(graph) -> int:
    """The device nodes of a captured graph: its kernel, memcpy and memset
    nodes, those of its child graphs included, read through the CUDA
    driver; a graph that is not a ``torch.cuda.CUDAGraph`` (an emulation's)
    gives its own ``nodes``, else 0."""
    if not isinstance(graph, torch.cuda.CUDAGraph):
        return int(getattr(graph, "nodes", 0))
    counts = (ctypes.c_longlong * 3)()
    _call("pps_graph_count_nodes", graph.raw_cuda_graph(), counts)
    return sum(counts)


# set while a capture's warm-up call runs (``warming``), while a piece is
# captured, the function that cuts it at a loop that runs inside it, and the
# label of the pieces captured now
_capture_state = {"warming": 0, "cut": None, "label": "piece"}


@contextlib.contextmanager
def labelled(label: str):
    """The pieces captured in the block are the spans
    ``pps.graphs.piece.<label>``."""
    prev, _capture_state["label"] = _capture_state["label"], label
    try:
        yield
    finally:
        _capture_state["label"] = prev


def warming() -> bool:
    """Whether a capture's warm-up call is running: the time at which a
    loop that runs inside a piece captures its pass (:class:`PieceLoop`),
    since no capture is in progress then."""
    return _capture_state["warming"] > 0


@contextlib.contextmanager
def warm_up():
    """The warm-up call of a capture (see :func:`warming`)."""
    _capture_state["warming"] += 1
    try:
        yield
    finally:
        _capture_state["warming"] -= 1


def capturing(t: torch.Tensor) -> bool:
    """Whether work on ``t`` is being captured: ``t`` on a CUDA device
    whose current stream is capturing."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def cut(loop: "PieceLoop") -> None:
    """Inside the capture of a piece: end its current graph here, put
    ``loop`` (whose static state the piece has just written) after it, and
    capture what follows into a new graph (see :func:`capture`)."""
    if _capture_state["cut"] is None:
        raise RuntimeError("a loop inside a piece runs only under graphs.capture")
    _capture_state["cut"](loop)


def capture(fn, device: torch.device):
    """``fn`` (device work on static buffers on ``device`` only) captured
    as a CUDA graph with its own memory pool, after one warm-up call on a
    side stream, as torch requires (the warm-up also fills the lazy caches
    ``fn`` reaches, such as the stencil libraries' loading, and captures
    the pass of each loop that runs inside ``fn``); returns once the
    warm-up is done.  ``(graph, launches)``: the counts the capture made,
    one call's (a ``utils.counters.minus``).  The graph keeps its nodes
    (``keep_graph``), so that it can be composed into another graph and
    read back (``raw_cuda_graph``); it is instantiated here too, for the
    per-piece replay.

    A loop that runs inside ``fn`` (:class:`PieceLoop`) cuts it: the
    CUDA driver refuses to clone a graph that holds a WHILE node into a
    child-graph node (``cudaErrorNotSupported``), so each such loop ends
    the graph being captured, and what follows it is captured into a new
    graph of the same memory pool (replayed in the order of capture, as a
    shared pool requires).  ``graph`` is then the list of the pieces
    (``_Piece``) and loops in order, and ``launches`` the pieces' sum."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), warm_up():
            fn()
        torch.cuda.current_stream().wait_stream(side)
        items: list = []
        pool = torch.cuda.graph_pool_handle()
        open_ = {}
        first = counters.snapshot()
        label = "pps.graphs.piece." + _capture_state["label"]

        def begin():
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            open_["graph"], open_["before"] = graph, counters.snapshot()
            graph.capture_begin(pool=pool)
            part = len(items) // 2  # a piece and a loop per cut
            open_["span"] = span(f"{label}.{part}" if part else label)
            open_["span"].__enter__()

        def end():
            open_["span"].__exit__(None, None, None)
            open_["graph"].capture_end()
            open_["after"] = counters.snapshot()
            items.append(_Piece(open_["graph"],
                                counters.minus(open_["after"], open_["before"])))

        def cut_here(loop):
            end()
            items.append(loop)
            begin()

        # as torch.cuda.graph does before a capture; then no garbage
        # collection inside the capture: a collected graph's destruction
        # (its exec's, or a GraphLoop's) is a call the capture forbids, and
        # it invalidates it
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        collect = gc.isenabled()
        gc.disable()
        stream = torch.cuda.Stream()
        prev, _capture_state["cut"] = _capture_state["cut"], cut_here
        try:
            with torch.cuda.stream(stream):
                begin()
                try:
                    fn()
                except BaseException:
                    # end the span and the capture the failure left open,
                    # then raise
                    with contextlib.suppress(RuntimeError):
                        open_["span"].__exit__(None, None, None)
                    with contextlib.suppress(RuntimeError):
                        open_["graph"].capture_end()
                    raise
                end()
        finally:
            _capture_state["cut"] = prev
            if collect:
                gc.enable()
        pieces = [item for item in items if isinstance(item, _Piece)]
        for piece in pieces:
            piece.graph.instantiate()
        torch.cuda.synchronize()
    if len(items) == 1:
        return items[0].graph, items[0].launches
    return items, counters.minus(open_["after"], first)


def _clone(state):
    """Static copies of every tensor of a (nested) NamedTuple state."""
    return type(state)(*(_clone(t) if isinstance(t, tuple) else t.clone() for t in state))


def _write(dst, src) -> None:
    """Copy the state ``src`` into the static state ``dst``, field by field
    (a piece returns fresh tensors, a field's own buffer unchanged, or
    ``None`` for a field it leaves as it is)."""
    for d, t in zip(dst, src):
        if t is None or t is d:
            continue
        if isinstance(d, tuple):
            _write(d, t)
        else:
            d.copy_(t)


class _Piece(NamedTuple):
    graph: object  # the captured torch.cuda.CUDAGraph
    launches: dict  # its counts (a counters.minus)
    nodes: int = 0  # its device nodes (count_nodes)


class _Loop(NamedTuple):
    index: int  # the loop's slot in GraphLoop.runs
    go: torch.Tensor  # its guard flag, a static buffer
    body: list  # pieces and loops


# composed graphs to destroy once no capture is in progress
_doomed: list = []


def _destroy(graph, exec_) -> None:
    """Destroy a composed graph and its executable (a GraphLoop's
    finalizer), or, while a capture is in progress, where the call would
    invalidate it, at the next launch or build."""
    if _lib is None:
        return
    _doomed.append((graph, exec_))
    if torch.cuda.is_current_stream_capturing():
        return
    while _doomed:
        _lib.pps_graph_destroy(*_doomed.pop())


class PieceLoop:
    """A loop that runs inside a captured piece, such as the batched patch
    BiCGStab inside each smoothing of a V-cycle inside a Krylov step: the
    counterpart of a ``lax.while_loop`` nested in the reference's jitted
    program.  ``state`` (a NamedTuple of tensors with the pass count ``k``
    and the guard ``go``, both 0-d) is copied into a static state, and
    ``step`` (one pass, device work only, ending with the guard re-tested)
    is captured once over it (:func:`capture`, during a warm-up, when no
    capture is in progress).  ``graph`` and ``launches`` are the pass's.

    Under the capture of a piece, :meth:`captured` writes a run's initial
    state into the static state and cuts the piece there (:func:`cut`):
    the loop becomes a WHILE node of the composed graph (``GraphLoop``),
    between the piece's graph up to it and the one after it, so one launch
    runs it on the card; the per-step replay reads its guard before every
    pass.  ``largest``: the most passes of one run since it was zeroed."""

    def __init__(self, state, step: Callable, device: torch.device):
        self.state = _clone(state)
        self.go = self.state.go
        with labelled("patch_pass"):
            self.graph, self.launches = capture(
                lambda: _write(self.state, step(self.state)), device)
        self.largest = torch.zeros((), dtype=torch.int64, device=device)
        self._runs = torch.zeros(1, dtype=torch.int64, device=device)
        self._exec = None

    def replay(self, state):
        """A run from ``state`` outside a capture (the warm-up's): on the
        card the loop alone as one graph launch, no host read; else the
        captured pass replayed while the guard read to the host holds.  The
        static state after it."""
        _write(self.state, state)
        if self.go.is_cuda:
            self._launch()
        else:
            while read_flag(self.go):
                self.graph.replay()
                counters.add(self.launches)
        return self.state

    def _launch(self) -> None:
        if self._exec is None:
            build()
            root, node, body = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_void_p()
            handle, guard = ctypes.c_ulonglong(), ctypes.c_void_p()
            _call("pps_graph_create", ctypes.byref(root))
            _call("pps_graph_add_while", root, None, self.go.data_ptr(), self._runs.data_ptr(),
                  ctypes.byref(node), ctypes.byref(body), ctypes.byref(handle))
            _call("pps_graph_add_child", body, None, self.graph.raw_cuda_graph(),
                  ctypes.byref(node))
            _call("pps_graph_add_guard", body, node, handle.value, self.go.data_ptr(),
                  self._runs.data_ptr(), ctypes.byref(guard))
            exec_ = ctypes.c_void_p()
            _call("pps_graph_instantiate", root, ctypes.byref(exec_))
            self._exec = exec_.value
            weakref.finalize(self, _destroy, root.value, self._exec)
        _call("pps_graph_launch", self._exec,
              torch.cuda.current_stream(self.go.device).cuda_stream)

    def captured(self, state):
        """Under the capture of a piece: a run from ``state`` as a loop of
        the composed graph; the static state after it."""
        _write(self.state, state)
        cut(self)
        torch.maximum(self.largest, self.state.k, out=self.largest)
        return self.state


#: the loops that run inside pieces (:class:`PieceLoop`, and the plain
#: versions of their owners): ``passes`` and ``runs`` (entries), and the
#: most passes of one run; reset with ``launches``
inner = {"passes": 0, "runs": 0, "largest": 0}


def note_inner(passes: int) -> None:
    """Count one run of a loop inside a piece that made ``passes``
    passes."""
    inner["passes"] += passes
    inner["runs"] += 1
    inner["largest"] = max(inner["largest"], passes)


class GraphLoop:
    """A program over a static state, its pieces captured once and run as
    one CUDA graph with WHILE nodes (:meth:`launch`) or piece by piece
    with host guard reads (:meth:`replay`).

    ``inputs``: static buffers the caller fills before a run; ``init(*inputs)``
    the state a run starts from (``None`` for a field it leaves as it is);
    ``body``: the pieces (``state -> state``) and ``krylov.While`` loops
    after it; ``template()``: a state (computed eagerly, here) whose copy
    is the static state; ``step``: the piece whose graph and launches are
    :attr:`graph` and :attr:`launches` (the loop's step).  A piece that
    runs loops inside it (:class:`PieceLoop`) is cut at each: the parts and
    the loops take its place in :attr:`tree` (the loops in the slots
    listed in :attr:`inner`), and its graph is then the list of them.  The
    launches of the set-up are no solve's and are taken back.
    ``capture_s``: the host seconds of the set-up and the captures;
    ``build_s``: those of the composition and instantiation, at the first
    :meth:`launch`."""

    @profiling.spanned("pps.graphs.capture", device=False)
    def __init__(self, inputs: tuple, init: Callable, body: tuple, template: Callable,
                 step: Callable, device: torch.device):
        t0 = time.perf_counter()
        before, inner_before = counters.snapshot(), dict(inner)
        self.inputs, self.device = inputs, torch.device(device)
        with warm_up():  # loops inside pieces run here without host reads
            self.state = _clone(template())
        self.whiles: list = []
        #: ``(slot, PieceLoop)`` of each loop run inside a piece; the slots
        #: of the program's own loops, in order
        self.inner: list = []
        self.loop_slots: list = []
        self.pieces: dict = {}
        self.tree = self._capture(lambda _: init(*self.inputs), "init")
        self.init = self.tree[0]
        self.tree += self._capture_body(body)
        self.graph, self.launches = self.pieces[step][:2]
        self.piece_loops = list({id(pl): pl for _, pl in self.inner}.values())
        self.runs = torch.zeros(len(self.whiles), dtype=torch.int64, device=self.device)
        counters.add(counters.minus(counters.snapshot(), before), -1)
        inner.update(inner_before)
        self.capture_s = time.perf_counter() - t0
        self.build_s = 0.0
        self.root = self._exec = None
        #: per loop slot: its body graph (of the composed graph); per WHILE
        #: node: its body graph
        self.bodies: dict = {}
        self.loop_nodes: dict = {}

    def _capture(self, fn: Callable, label: str) -> list:
        """``fn`` captured (its pieces labelled ``label``): its part of the
        tree (one piece, or the parts and loops of a cut piece)."""
        with labelled(label):
            graph, launched = capture(lambda: _write(self.state, fn(self.state)),
                                      self.device)
        if not isinstance(graph, list):
            self.pieces[fn] = piece = _Piece(graph, launched, count_nodes(graph))
            return [piece]
        self.pieces[fn] = _Piece(graph, launched)
        tree = []
        for item in graph:
            if isinstance(item, PieceLoop):
                loop = _Loop(len(self.whiles), item.go,
                             [_Piece(item.graph, item.launches, count_nodes(item.graph))])
                self.whiles.append(loop)
                self.inner.append((loop.index, item))
                item = loop
            else:
                item = item._replace(nodes=count_nodes(item.graph))
            tree.append(item)
        return tree

    def _capture_body(self, body: tuple) -> list:
        tree = []
        for item in body:
            if isinstance(item, While):
                index = len(self.whiles)
                self.whiles.append(item)
                self.loop_slots.append(index)
                tree.append(_Loop(index, item.guard(self.state), self._capture_body(item.body)))
            else:
                tree += self._capture(item, getattr(item, "__name__", "piece"))
        return tree

    # -- a run ----------------------------------------------------------------

    def run(self, one: bool, *extra: torch.Tensor, sync: bool = True):
        """One run: one graph launch on the card with ``one`` (else piece by
        piece, :meth:`replay`), then one host read of the passes, the
        largest runs of the loops inside pieces and ``extra``, and the
        launch accounting.  ``(runs, values)``: the passes per loop slot and
        the values of ``extra`` read.  With ``sync=False`` nothing is read
        (the accounting waits for the next ``counters.flush``);
        ``(None, None)``."""
        for pl in self.piece_loops:
            pl.largest.zero_()
        launched = one and self.device.type == "cuda"
        if launched:
            self.launch()
            runs = None
        else:
            runs = self.replay()
        counts = (([self.runs] if launched else [])
                  + ([torch.stack([pl.largest for pl in self.piece_loops])]
                     if self.piece_loops else []))
        if not sync:
            if counts:
                snap = torch.cat(counts).clone()
                counters.defer(lambda: self._account(host_read(snap)[0], runs))
            return None, None
        if not counts and not extra:
            return runs, []
        got = host_read(*counts, *extra)
        n = len(counts)
        runs = self._account(np.concatenate(got[:n]) if n else np.zeros(0), runs)
        return runs, got[n:]

    def _account(self, values, runs):
        """The accounting of a run from the counts read (``values``: the
        passes per slot after a launch, then the largest runs); ``runs``:
        the passes per slot of a replay (``None`` after a launch).  The
        passes per slot."""
        values = [int(v) for v in values]
        if runs is None:
            runs, values = values[:len(self.whiles)], values[len(self.whiles):]
            self.account(runs)
        else:
            self._account_inner(self.tree, 1, runs)
        if self.piece_loops:
            inner["largest"] = max(inner["largest"], *values)
        return runs

    def _account_inner(self, tree: list, times: int, runs) -> None:
        """The passes and runs of the loops inside pieces (``inner``)."""
        slots = dict(self.inner)
        for item in tree:
            if isinstance(item, _Loop):
                n = int(runs[item.index])
                if item.index in slots:
                    inner["passes"] += n
                    inner["runs"] += times
                self._account_inner(item.body, n, runs)

    # -- the plain version: piece by piece, guards read on the host ----------

    def replay(self) -> list:
        """One run piece by piece: each piece's graph replayed (its
        launches and nodes added per replay), each loop's guard read to the
        host before every pass.  The passes per loop slot."""
        runs = [0] * len(self.whiles)
        with span("pps.graphs.replay", device=False):
            self._replay_tree(self.tree, runs)
        return runs

    def _replay_piece(self, piece: _Piece) -> None:
        piece.graph.replay()
        counters.add(piece.launches)
        launches["nodes"] += piece.nodes

    def _replay_tree(self, tree: list, runs: list) -> None:
        for item in tree:
            if isinstance(item, _Loop):
                while read_flag(item.go):
                    self._replay_tree(item.body, runs)
                    runs[item.index] += 1
            else:
                self._replay_piece(item)

    # -- one graph launch ------------------------------------------------------

    def launch(self) -> None:
        """One run as one launch of the composed graph on the current
        stream (composed and instantiated at the first); the passes per
        loop slot are then in :attr:`runs`, on the card.  Raises if the
        driver refuses the graph."""
        if self._exec is None:
            self._build()
        while _doomed:
            _lib.pps_graph_destroy(*_doomed.pop())
        with span("pps.graphs.launch", device=False):
            _call("pps_graph_launch", self._exec,
                  torch.cuda.current_stream(self.device).cuda_stream)
        launches["graph"] += 1

    def account(self, runs) -> None:
        """Add the kernel counts, guard runs and device nodes of a launch
        that made ``runs`` passes per loop slot (host integers), and the
        passes and runs of the loops inside pieces."""
        def walk(tree, times):
            for item in tree:
                if isinstance(item, _Loop):
                    n = int(runs[item.index])
                    launches["guard"] += times + n
                    launches["nodes"] += times + n
                    launches["passes"] += n
                    walk(item.body, n)
                else:
                    counters.add(item.launches, times)
                    launches["nodes"] += item.nodes * times

        if self.whiles:
            launches["nodes"] += 1  # the memset that zeroes the pass counters
        walk(self.tree, 1)
        self._account_inner(self.tree, 1, runs)

    @profiling.spanned("pps.graphs.build", device=False)
    def _build(self) -> None:
        t0 = time.perf_counter()
        build()
        root = ctypes.c_void_p()
        _call("pps_graph_create", ctypes.byref(root))
        self.root = root.value
        dep = None
        if self.whiles:
            node = ctypes.c_void_p()
            _call("pps_graph_add_zero", self.root, None, self.runs.data_ptr(),
                  len(self.whiles), ctypes.byref(node))
            dep = node.value
        self._compose(self.root, self.tree, dep)
        exec_ = ctypes.c_void_p()
        try:
            _call("pps_graph_instantiate", self.root, ctypes.byref(exec_))
        except RuntimeError:
            _destroy(self.root, None)
            self.root = None
            raise
        self._exec = exec_.value
        weakref.finalize(self, _destroy, self.root, self._exec)
        self.build_s = time.perf_counter() - t0

    def _add_child(self, graph, dep, piece: _Piece):
        node = ctypes.c_void_p()
        _call("pps_graph_add_child", graph, dep, piece.graph.raw_cuda_graph(),
              ctypes.byref(node))
        return node.value

    def _compose(self, graph, tree: list, dep):
        """The pieces and loops of ``tree`` added to ``graph`` after
        ``dep``, in order; the last node."""
        for item in tree:
            if isinstance(item, _Loop):
                node, body = ctypes.c_void_p(), ctypes.c_void_p()
                handle = ctypes.c_ulonglong()
                runs = self.runs.data_ptr() + 8 * item.index
                go = item.go.data_ptr()
                _call("pps_graph_add_while", graph, dep, go, runs, ctypes.byref(node),
                      ctypes.byref(body), ctypes.byref(handle))
                last = self._compose(body.value, item.body, None)
                guard = ctypes.c_void_p()
                _call("pps_graph_add_guard", body.value, last, handle.value, go, runs,
                      ctypes.byref(guard))
                self.bodies[item.index] = body.value
                self.loop_nodes[node.value] = body.value
                dep = node.value
            else:
                dep = self._add_child(graph, dep, item)
        return dep


def _fresh(res: KrylovResult) -> KrylovResult:
    return res._replace(x=res.x.clone(), residual_norm=res.residual_norm.clone(),
                        r0_norm=res.r0_norm.clone())


class CapturedLoop:
    """The Krylov loop ``loop`` (``krylov.KrylovLoop``) with its init and
    pieces captured once, over static copies of the state
    ``loop.init(b, tol, max_iter)`` gives, and composed into one graph
    (:class:`GraphLoop`).  :meth:`run` is one graph launch followed by one
    read (the passes, hence the step count).  ``graph`` and ``launches``
    are those of the loop's step, ``capture_s`` the set-up's seconds.

    With ``prepare`` the loop runs on ``prepare(b)``, computed in its init
    piece, and with ``finish`` a last piece computes ``finish(b, state)``
    (a field of ``b``'s shape and dtype; the state's ``x``), which
    :meth:`run` returns beside the result: the Schur path's right-hand side
    and recovery, so that they run in the solve's one launch."""

    def __init__(self, loop: KrylovLoop, b: torch.Tensor, tol, max_iter: int,
                 prepare: Optional[Callable] = None, finish: Optional[Callable] = None):
        self.loop, self.finish = loop, finish
        self.b = b.clone()
        self.tol = _scalar(tol, b).clone()
        self.max_iter = torch.full((), max_iter, dtype=torch.int64, device=b.device)
        init = loop.init
        if prepare is not None:
            def init(b, tol, max_iter):
                return loop.init(prepare(b), tol, max_iter)
        body = program(loop)
        if finish is not None:
            self.out = torch.empty_like(self.b)

            def recover(s):
                self.out.copy_(finish(self.b, s))
                return s

            body += (recover,)
        self.graphs = GraphLoop((self.b, self.tol, self.max_iter), init, body,
                                lambda: init(self.b, tol, max_iter), loop.step, b.device)
        self.state = self.graphs.state
        self.graph, self.launches = self.graphs.graph, self.graphs.launches
        self.capture_s = self.graphs.capture_s

    def run(self, b: torch.Tensor, tol, max_iter: int, one: bool = True):
        """The loop on ``b`` (cast to the loop's dtype) to its stop: on the
        card with ``one``, one graph launch and one read (the passes, hence
        the step count, and the fields the result needs); else piece by
        piece (the CPU's way, and the per-step replay on the card)."""
        self.b.copy_(b)
        self.tol.fill_(tol)
        self.max_iter.fill_(max_iter)
        loop = self.loop
        extra = [getattr(self.state, name) for name in ((loop.count,) if loop.count else ())
                 + loop.read]
        runs, got = self.graphs.run(one, *extra)
        iterations = int(got[0][0]) if loop.count else runs[self.graphs.loop_slots[0]]
        res = loop.result(self.state, iterations, *got[1 if loop.count else 0:])
        if isinstance(res, tuple) and not isinstance(res, KrylovResult):
            res = (_fresh(res[0]), *res[1:])
        else:
            res = _fresh(res)
        return res if self.finish is None else (res, self.out.clone())

    def _replay(self, state):
        """One replay of the step alone (its launches added)."""
        self.graph.replay()
        counters.add(self.launches)
        return state

