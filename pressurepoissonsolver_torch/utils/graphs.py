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
the inner Krylov loop, GMRES's cycles around its Arnoldi steps).

The plain version of the WHILE node is ``krylov.run_loop``: the same
pieces replayed one by one, each loop's guard read to the host before
every pass (:meth:`GraphLoop.replay`).  The CPU takes it (with an
emulation of :func:`capture`, in the tests), and so does the per-step
replay kept for comparison on the card.  A conditional node that the
driver refuses, or a build that fails, raises; there is no fallback.

Inputs (the right-hand side, ``tol``, the step limits) are static buffers
copied in before a run, so no new value needs a new capture.  Results are
fresh tensors, never views of the graph's buffers.  The stencil wrappers
count their launches on the host, where a graph does not pass: the
launches of each piece are recorded at capture and added per replay, or,
after a graph launch, times the passes the launch made (read with the
results, or later by ``ghost_stencil.counters()``).  ``launches`` counts
the guard kernel's runs, the WHILE-node passes and the graph launches.
"""

from __future__ import annotations

import ctypes
import gc
import time
import weakref
from typing import Callable, NamedTuple, Optional

import torch

from .. import cuda_build
from ..krylov import (KrylovLoop, KrylovResult, While, _scalar, host_read, program,
                      read_flag)
from ..ops import ghost_stencil

#: ``guard``: runs of the guard kernel (one ahead of each entry of a WHILE
#: node, one per pass); ``passes``: WHILE-node passes; ``graph``: graph
#: launches of whole solves
launches = {"guard": 0, "passes": 0, "graph": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build() -> ctypes.CDLL:
    """Compile (at first use) and load ``csrc/graph_loop.cu``."""
    global _lib
    if _lib is None:
        lib = cuda_build.load_library("graph_loop", ["graph_loop.cu"])
        vp, pp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        sig = {
            "pps_graph_create": [pp],
            "pps_graph_add_zero": [vp, vp, vp, ctypes.c_int, pp],
            "pps_graph_add_child": [vp, vp, vp, pp],
            "pps_graph_add_while": [vp, vp, vp, vp, pp, pp,
                                    ctypes.POINTER(ctypes.c_ulonglong)],
            "pps_graph_add_guard": [vp, vp, ctypes.c_ulonglong, vp, vp, pp],
            "pps_graph_instantiate": [vp, pp],
            "pps_graph_launch": [vp, vp],
            "pps_graph_destroy": [vp, vp],
            "pps_graph_driver_version": [ctypes.POINTER(ctypes.c_int)],
            "pps_graph_runtime_version": [ctypes.POINTER(ctypes.c_int)],
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


def _minus(after: list, before: list) -> list:
    """The launches between two ``ghost_stencil.counters()``."""
    return [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]


def capture(fn, device: torch.device):
    """``fn`` (device work on static buffers on ``device`` only) captured
    as a CUDA graph with its own memory pool, after one warm-up call on a
    side stream, as torch requires (the warm-up also fills the lazy caches
    ``fn`` reaches, such as the stencil libraries' loading); returns once
    the warm-up is done.  ``(graph, launches)``: the stencil launches the
    capture counted, one call's.  The graph keeps its nodes
    (``keep_graph``), so that it can be composed into another graph and
    read back (``raw_cuda_graph``); it is instantiated here too, for the
    per-piece replay."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = ghost_stencil.counters()
        # no garbage collection inside the capture (torch collects just
        # before it): a collected graph's destruction (its exec's, or a
        # GraphLoop's) is a call the capture forbids, and it invalidates it
        collect = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                fn()
        finally:
            if collect:
                gc.enable()
        launches = _minus(ghost_stencil.counters(), before)
        graph.instantiate()
        torch.cuda.synchronize()
    return graph, launches


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
    launches: list  # its stencil launches


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


class GraphLoop:
    """A program over a static state, its pieces captured once and run as
    one CUDA graph with WHILE nodes (:meth:`launch`) or piece by piece
    with host guard reads (:meth:`replay`).

    ``inputs``: static buffers the caller fills before a run; ``init(*inputs)``
    the state a run starts from (``None`` for a field it leaves as it is);
    ``body``: the pieces (``state -> state``) and ``krylov.While`` loops
    after it; ``template()``: a state (computed eagerly, here) whose copy
    is the static state; ``step``: the piece whose graph and launches are
    :attr:`graph` and :attr:`launches` (the loop's step).  The launches of
    the set-up are no solve's and are taken back.  ``capture_s``: the host
    seconds of the set-up and the captures; ``build_s``: those of the
    composition and instantiation, at the first :meth:`launch`."""

    def __init__(self, inputs: tuple, init: Callable, body: tuple, template: Callable,
                 step: Callable, device: torch.device):
        t0 = time.perf_counter()
        before = ghost_stencil.counters()
        self.inputs, self.device = inputs, torch.device(device)
        self.state = _clone(template())
        self.whiles: list = []
        self.pieces: dict = {}
        self.init = self._capture(lambda _: init(*self.inputs))
        self.tree = self._capture_body(body)
        self.graph, self.launches = self.pieces[step]
        self.runs = torch.zeros(len(self.whiles), dtype=torch.int64, device=self.device)
        ghost_stencil.add_launches(_minus(ghost_stencil.counters(), before), -1)
        self.capture_s = time.perf_counter() - t0
        self.build_s = 0.0
        self.root = self._exec = None
        #: per loop slot: its body graph (of the composed graph); per WHILE
        #: node: its body graph
        self.bodies: dict = {}
        self.loop_nodes: dict = {}

    def _capture(self, fn: Callable) -> _Piece:
        graph, launched = capture(lambda: _write(self.state, fn(self.state)), self.device)
        piece = _Piece(graph, launched)
        self.pieces[fn] = piece
        return piece

    def _capture_body(self, body: tuple) -> list:
        tree = []
        for item in body:
            if isinstance(item, While):
                index = len(self.whiles)
                self.whiles.append(item)
                tree.append(_Loop(index, item.guard(self.state), self._capture_body(item.body)))
            else:
                tree.append(self._capture(item))
        return tree

    # -- the plain version: piece by piece, guards read on the host ----------

    def replay(self) -> list:
        """One run piece by piece: each piece's graph replayed (its
        launches added per replay), each loop's guard read to the host
        before every pass.  The passes per loop slot."""
        runs = [0] * len(self.whiles)
        self._replay_piece(self.init)
        self._replay_tree(self.tree, runs)
        return runs

    def _replay_piece(self, piece: _Piece) -> None:
        piece.graph.replay()
        ghost_stencil.add_launches(piece.launches)

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
        _call("pps_graph_launch", self._exec,
              torch.cuda.current_stream(self.device).cuda_stream)
        launches["graph"] += 1

    def account(self, runs) -> None:
        """Add the stencil launches and guard runs of a launch that made
        ``runs`` passes per loop slot (host integers)."""
        ghost_stencil.add_launches(self.init.launches)

        def walk(tree, times):
            for item in tree:
                if isinstance(item, _Loop):
                    n = int(runs[item.index])
                    launches["guard"] += times + n
                    launches["passes"] += n
                    walk(item.body, n)
                else:
                    ghost_stencil.add_launches(item.launches, times)

        walk(self.tree, 1)

    def level_launches(self) -> dict:
        """Per graph level (``"root"`` or a loop slot): the stencil launches
        of the pieces directly in it, per dimension and dtype name, which
        the stencil kernel nodes of that level's graph must equal."""
        out = {}

        def add(level, piece):
            acc = out.setdefault(level, {2: {"float32": 0, "float64": 0},
                                         3: {"float32": 0, "float64": 0}})
            for D in (2, 3):
                for dt, v in piece.launches[D - 2].items():
                    acc[D][dt] += v

        def walk(tree, level):
            out.setdefault(level, {2: {"float32": 0, "float64": 0},
                                   3: {"float32": 0, "float64": 0}})
            for item in tree:
                if isinstance(item, _Loop):
                    walk(item.body, item.index)
                else:
                    add(level, item)

        add("root", self.init)
        walk(self.tree, "root")
        return out

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
        dep = self._add_child(self.root, dep, self.init)
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
    are those of the loop's step, ``capture_s`` the set-up's seconds."""

    def __init__(self, loop: KrylovLoop, b: torch.Tensor, tol, max_iter: int):
        self.loop = loop
        self.b = b.clone()
        self.tol = _scalar(tol, b).clone()
        self.max_iter = torch.full((), max_iter, dtype=torch.int64, device=b.device)
        self.graphs = GraphLoop((self.b, self.tol, self.max_iter), loop.init,
                                program(loop), lambda: loop.init(self.b, tol, max_iter),
                                loop.step, b.device)
        self.state = self.graphs.state
        self.graph, self.launches = self.graphs.graph, self.graphs.launches
        self.capture_s = self.graphs.capture_s

    def run(self, b: torch.Tensor, tol, max_iter: int, one: bool = True):
        """The loop on ``b`` (cast to the loop's dtype) to its stop: on the
        card with ``one``, one graph launch and one read; else piece by
        piece (the CPU's way, and the per-step replay on the card)."""
        self.b.copy_(b)
        self.tol.fill_(tol)
        self.max_iter.fill_(max_iter)
        count = self.loop.count
        if one and self.b.is_cuda:
            self.graphs.launch()
            extra = (getattr(self.state, count),) if count else ()
            got = host_read(self.graphs.runs, *extra)
            runs = [int(v) for v in got[0]]
            self.graphs.account(runs)
            iterations = int(got[1][0]) if count else runs[0]
        else:
            runs = self.graphs.replay()
            iterations = (int(host_read(getattr(self.state, count))[0][0]) if count
                          else runs[0])
        res = self.loop.result(self.state, iterations)
        if isinstance(res, tuple) and not isinstance(res, KrylovResult):
            return (_fresh(res[0]), *res[1:])
        return _fresh(res)

    def _replay(self, state):
        """One replay of the step alone (its launches added)."""
        self.graph.replay()
        ghost_stencil.add_launches(self.launches)
        return state

