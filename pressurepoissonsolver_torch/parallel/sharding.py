"""Patch-axis sharding over ``torch.distributed``: one rank per device.

Port of ``pressurepoissonsolver_tpu.parallel.sharding``.  The reference
drives a 1D ``jax.sharding.Mesh`` from one process and lets XLA place the
collectives; here a sharded solve is SPMD:

* every rank runs the same program on its own device (``cuda:<local
  rank>`` on the card, wrapped onto the cards there are; the CPU in the
  tests) and holds a contiguous block of ``P/k`` rows of every ``[P,
  ...]`` patch field: rank ``r`` has rows ``r*P/k .. (r+1)*P/k - 1`` of
  the Morton-ordered, padded level (``domain.DomainHierarchy(...,
  num_shards=k)``);
* the mesh is a 1D :class:`~torch.distributed.device_mesh.DeviceMesh`
  named ``("p",)`` over the process group (:func:`make_mesh`); results
  are plain local tensors, and every collective is explicit
  (:class:`Comm`): point-to-point batches for the halo exchange
  (:mod:`.halo`), ``all_reduce`` for the dots, norms and integrals,
  ``all_gather`` for :func:`gather_patches` and the coarse direct solve.

Padding: patch counts are padded to a multiple of the rank count with
isolated dummy patches (no neighbours, zero right-hand side), which stay
identically zero through every linear operation.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..domain import PatchLevel
from ..utils.profiling import span

#: the mesh's one axis: patches
AXIS = "p"


def default_backend() -> str:
    """NCCL when there is a CUDA card, gloo on the CPU."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def local_device() -> torch.device:
    """This rank's card, ``cuda:<LOCAL_RANK mod cards>`` (every rank of a
    one-card machine sits on ``cuda:0``); raises without a card (a caller
    that wants the CPU names it)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, *, backend: Optional[str] = None):
    """A 1D ``DeviceMesh`` named ``("p",)`` over the default process group.

    Without an initialised group, one is started: from ``torchrun``'s
    environment (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``) when it is set,
    else as a one-rank group in this process.  The backend is ``backend``,
    else NCCL with a CUDA card and gloo without; a failed start raises and
    never falls back to another backend.  ``n_devices``, when given, must
    equal the group's size."""
    if not dist.is_initialized():
        backend = backend or default_backend()
        if backend == "nccl":
            torch.cuda.set_device(local_device())
        if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend)
        else:
            if n_devices not in (None, 1):
                raise ValueError(
                    f"make_mesh({n_devices}): no process group and no torchrun "
                    "environment; start the ranks with torchrun or "
                    "init_process_group")
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"backend={backend!r} but the process group runs "
                         f"{dist.get_backend()!r}")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}) in a group of {world} ranks")
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, list(range(world)), mesh_dim_names=(AXIS,))


class _Pending:
    """An exchange in flight (:meth:`Comm.exchange_start`): its requests,
    its send and receive buffers (held until it finishes), the key of its
    pinned buffers when staged, and the device the received rows go to."""

    __slots__ = ("reqs", "recv", "send", "key", "device")

    def __init__(self, reqs, recv, send, key, device):
        self.reqs, self.recv, self.send, self.key, self.device = (
            reqs, recv, send, key, device)


class Comm:
    """The collectives of a sharded solve over ``mesh``'s group, for tensors
    on ``device``.

    ``host_staged`` is decided here, once: with the gloo backend and a CUDA
    device, every collective copies its tensors to the host and back
    (gloo's point-to-point and all-gather take CPU tensors only); NCCL and
    CPU tensors under gloo take the tensors as they are.

    The exchange is split (:meth:`exchange_start`, :meth:`exchange_finish`)
    so that a caller can queue work on the current stream while it is in
    flight.  Under NCCL the point-to-point ops run on NCCL's stream, which
    waits on the current stream when they are posted.  When staged (one
    pinned send and one pinned receive buffer per dtype, shape and rank
    offset), the send rows are copied to the host on the current stream at
    the start, before the caller queues anything behind it; the copy of the
    received rows back to the card runs on a side stream ordered by a CUDA
    event, so that it does not queue behind the caller's work: the current
    stream waits on that event at the finish, and a receive buffer is not
    posted again before the copy out of it has ended.  The span
    ``pps.halo.exchange_wait`` covers the waits alone."""

    def __init__(self, mesh, device):
        self.mesh = mesh
        self.group = mesh.get_group(AXIS)
        self.size = mesh.size()
        self.rank = mesh.get_local_rank(AXIS)
        self.ranks: List[int] = dist.get_process_group_ranks(self.group)
        self.backend = dist.get_backend(self.group)
        self.device = torch.device(device)
        self.host_staged = self.backend == "gloo" and self.device.type == "cuda"
        # per (dtype, shape, offset): pinned send and receive buffers and
        # the event of the last copy out of the receive buffer
        self._pinned: Dict[tuple, list] = {}
        self._side = (torch.cuda.Stream(self.device) if self.host_staged else None)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor on ``t``'s device)."""
        if self.host_staged:
            h = t.detach().to("cpu", copy=True)
            dist.all_reduce(h, group=self.group)
            return h.to(t.device)
        out = t.clone()
        dist.all_reduce(out, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (same shape on each) concatenated along the
        leading axis in rank order."""
        if self.backend == "nccl":
            out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
            dist.all_gather_into_tensor(out, t.contiguous(), group=self.group)
            return out
        src = t.detach().to("cpu") if self.host_staged else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim=0).to(t.device)

    def exchange_start(self, send: torch.Tensor, d: int) -> _Pending:
        """Post the send of ``send`` to rank ``(me + d) % k`` and the
        receive of the same-shaped tensor from ``(me - d) % k`` (one
        ``batch_isend_irecv``); :meth:`exchange_finish` returns what
        arrived.  Every rank of the group must call both, in the same
        order."""
        me, k = self.rank, self.size
        key = None
        if self.host_staged:
            key = (send.dtype, tuple(send.shape), d)
            if key not in self._pinned:
                self._pinned[key] = [
                    torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
                    for _ in range(2)] + [None]
            send_h, recv_h, copied = self._pinned[key]
            if copied is not None:
                copied.synchronize()  # the last copy out of recv_h has ended
            send_h.copy_(send)  # on the current stream, before the caller's work
        else:
            send_h, recv_h = send.contiguous(), torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send_h, self.ranks[(me + d) % k], self.group),
               dist.P2POp(dist.irecv, recv_h, self.ranks[(me - d) % k], self.group)]
        return _Pending(dist.batch_isend_irecv(ops), recv_h, send_h, key, send.device)

    def exchange_finish(self, pending: _Pending) -> torch.Tensor:
        """Wait for an exchange :meth:`exchange_start` posted; the received
        tensor, on the sender's device, ready for the current stream."""
        with span("pps.halo.exchange_wait", device=False):
            for req in pending.reqs:
                req.wait()
        if not self.host_staged:
            return pending.recv
        side, cur = self._side, torch.cuda.current_stream(self.device)
        with torch.cuda.stream(side):
            recv = torch.empty(pending.recv.shape, dtype=pending.recv.dtype,
                               device=pending.device)
            recv.copy_(pending.recv, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        self._pinned[pending.key][2] = done
        cur.wait_event(done)
        recv.record_stream(cur)
        return recv


def pad_level(pl: PatchLevel, multiple: int) -> PatchLevel:
    """Pad the patch tables with isolated dummy patches so the patch count
    divides the mesh size.  Dummy patches have no neighbors and Dirichlet
    walls; with zero RHS they remain exactly zero under every level op."""
    P_now = pl.num_patches
    pad = (-P_now) % multiple
    if pad == 0:
        return pl
    D, S = pl.D, 2 * pl.D
    half = 1 << (D - 1)

    def cat(a, fill, shape):
        extra = np.full((pad,) + shape, fill, dtype=a.dtype)
        return np.concatenate([a, extra], axis=0)

    max_id = int(pl.ids.max())
    new_ids = np.concatenate(
        [pl.ids, max_id + 1 + np.arange(pad, dtype=np.int64)]
    )
    return PatchLevel(
        D=D,
        n=pl.n,
        tree_level=pl.tree_level,
        ids=new_ids,
        starts=cat(pl.starts, 0.0, (D,)),
        spacings=cat(pl.spacings, 1.0, (D,)),
        refine_level=cat(pl.refine_level, 0, ()),
        parent_id=np.concatenate([pl.parent_id, new_ids[P_now:]]),  # own parent
        orth_on_parent=cat(pl.orth_on_parent, -1, ()),
        neumann=cat(pl.neumann, False, (S,)),
        nbr_type=cat(pl.nbr_type, 0, (S,)),
        nbr_slot=cat(pl.nbr_slot, -1, (S,)),
        coarse_orth=cat(pl.coarse_orth, -1, (S,)),
        fine_nbr_slots=cat(pl.fine_nbr_slots, -1, (S, half)),
        num_real=pl.real_patches,
    )


def row_block(P: int, mesh) -> slice:
    """This rank's rows of a ``[P, ...]`` field (``P`` a multiple of the
    mesh size)."""
    k, r = mesh.size(), mesh.get_local_rank(AXIS)
    if P % k:
        raise ValueError(f"pad the level first: P={P} % {k} != 0")
    Pl = P // k
    return slice(r * Pl, (r + 1) * Pl)


def shard_patch_array(x, mesh) -> torch.Tensor:
    """This rank's block of rows of the global patch field ``x``."""
    x = torch.as_tensor(x)
    return x[row_block(x.shape[0], mesh)]


def gather_patches(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global ``[P, ...]`` field from every rank's block (an
    all-gather; every rank must call it), on ``x``'s device."""
    return Comm(mesh, x.device).all_gather(x)
