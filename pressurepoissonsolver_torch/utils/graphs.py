"""The guarded step of a Krylov loop captured as a CUDA graph.

The reference compiles each solve into one XLA program (``jax.jit``
around a ``lax.while_loop``) and caches it per key.  The counterpart on
one CUDA card is :class:`CapturedLoop`: the step of a
:class:`~pressurepoissonsolver_torch.krylov.KrylovLoop` (the
preconditioner, the operator applies, the dots and axpys, the step count
and the stop test) captured once into a ``torch.cuda.CUDAGraph`` over
static copies of the loop's state, then replayed once per step.  The
host reads the guard once per step and replays the step while it holds
(:func:`~pressurepoissonsolver_torch.krylov.run_loop`): keeping the test
on the card across steps needs conditional graph nodes, which torch
2.11 cannot capture (no ``CUDAGraph.begin_capture_to_if_node``).

A solve copies its right-hand side into a static buffer and runs the
loop's init eagerly into the static state; ``tol`` and ``max_iter`` are
part of that state, so neither needs a new capture.  Results are fresh
tensors, never views of the graph's buffers.  The stencil wrappers count
their launches on the host, where a replay does not pass: the launches of
one captured step are recorded at capture and added per replay
(``ops.ghost_stencil.add_launches``), so that a captured solve counts what
the eager one does.  A capture that fails raises; there is no eager
fallback.
"""

from __future__ import annotations

import time

import torch

from ..krylov import KrylovLoop, KrylovResult, run_loop
from ..ops import ghost_stencil


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
    (``keep_graph``), so what it replays can be read back
    (``raw_cuda_graph``); it is instantiated here, not at its first
    replay."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = ghost_stencil.counters()
        with torch.cuda.graph(graph):
            fn()
        launches = _minus(ghost_stencil.counters(), before)
        graph.instantiate()
        torch.cuda.synchronize()
    return graph, launches


class CapturedLoop:
    """``loop`` with its step captured once, over static copies of the
    state ``loop.init(b, tol, max_iter)`` gives, and replayed per step by
    :meth:`run`.  ``capture_s`` is the host seconds of the warm-up and the
    capture, ``launches`` the stencil launches of one step."""

    def __init__(self, loop: KrylovLoop, b: torch.Tensor, tol, max_iter: int):
        t0 = time.perf_counter()
        self.loop = loop
        self.b = b.clone()
        before = ghost_stencil.counters()
        init = loop.init(self.b, tol, max_iter)
        self.state = type(init)(*(t.clone() for t in init))
        self.graph, self.launches = capture(
            lambda: self._write(loop.step(self.state)), self.b.device)
        # the launches of this set-up's init and warm-up are no solve's,
        # and the capture's are none
        ghost_stencil.add_launches(_minus(ghost_stencil.counters(), before), -1)
        self.capture_s = time.perf_counter() - t0

    def _write(self, new) -> None:
        """Copy the state ``new`` into the static state, field by field (a
        step returns fresh tensors, or a field's own buffer unchanged)."""
        for d, t in zip(self.state, new):
            if t is not d:
                d.copy_(t)

    def run(self, b: torch.Tensor, tol, max_iter: int) -> KrylovResult:
        """The loop on ``b`` (cast to the loop's dtype) to its stop: one
        host read and, while the guard holds, one replay per step."""
        self.b.copy_(b)
        self._write(self.loop.init(self.b, tol, max_iter))
        state, steps = run_loop(self.state, self._replay)
        res = self.loop.result(state, steps)
        return res._replace(x=res.x.clone(), r0_norm=res.r0_norm.clone())

    def _replay(self, state):
        self.graph.replay()
        ghost_stencil.add_launches(self.launches)
        return state
