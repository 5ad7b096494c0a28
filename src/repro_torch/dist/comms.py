"""Booking the collectives of a step, and the dry-run's process group.

:class:`BookedGroup` is a ``torch.distributed`` process group (a Python
backend, registered as ``"booked"``) that books every collective it runs
(:data:`BOOK`, one entry a call: the reference dry-run's kind, the op, the
dtype and shape of its result, its bytes) and then either runs it on an
inner group (``gloo``: a real run) or, with no inner group (the dry-run),
fills its outputs as if every rank of the group held this rank's data:
an all-gather tiles the input, a sum all-reduce multiplies it by the
group's size, a reduce-scatter takes the rank's slice times the size, an
all-to-all tiles the chunk this rank would receive; max, min and average
reductions and broadcasts leave it as it is.  The values mean nothing,
but every output is initialized (an id gathered by the MoE layer or the
retrieval merge stays in range), and a real run whose ranks all hold the
same data computes the same numbers, call for call.

The book sits under DTensor, so it sees every collective of a step: the
explicit ones, the redistributions of ``dist.spmd`` and those DTensor
runs inside an op's dispatch (a dispatch mode misses the last ones where
DTensor dispatches in C++).  :func:`by_kind` sums a book into the
reference's ``collective_stats``: its kinds, count and bytes, an
all-reduce counting twice its result (the ring model).
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist
from torch._C._distributed_c10d import ReduceOp, _create_work_from_future
from torch.futures import Future

__all__ = ["BookedGroup", "BOOK", "KINDS", "by_kind", "init_booked"]

# the reference dry-run's kinds (``collective_stats``)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

# every booked call of this process, in order
BOOK: list = []
_INNER: dict = {}          # backend "booked": {"inner": None | "gloo"}


def _done(result=None):
    fut = Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class BookedGroup(dist.ProcessGroup):
    """A group of ``size`` ranks, this one ``rank``, booking each
    collective into :data:`BOOK`; ``inner`` (a backend of the same ranks)
    runs them, or with None the outputs are filled (the module
    docstring)."""

    def __init__(self, rank: int, size: int, inner=None):
        super().__init__(rank, size)
        self._rank, self._size, self._inner = rank, size, inner

    def size(self):
        return self._size

    def getBackendName(self):
        return "booked"

    @property
    def group_name(self):
        return dist.distributed_c10d._world.pg_names[self]

    def __repr__(self):
        how = "dry" if self._inner is None else "gloo"
        return f"BookedGroup({how}, rank {self._rank} of {self._size})"

    def _book(self, kind, op, out) -> None:
        BOOK.append({"kind": kind, "op": op, "group_size": self._size,
                     "dtype": str(out.dtype).removeprefix("torch."),
                     "shape": list(out.shape), "bytes": _nbytes(out)})

    # -- reductions ---------------------------------------------------------
    def allreduce(self, tensors, opts=None):
        for t in tensors:
            self._book("all-reduce", "all_reduce", t)
        if self._inner is not None:
            return self._inner.allreduce(tensors, opts)
        if opts is None or opts.reduceOp == ReduceOp.SUM:
            for t in tensors:
                t.mul_(self._size)
        return _done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        return self.allreduce(tensors, opts)

    def _reduce_scatter_base(self, output, input, opts=None):
        self._book("reduce-scatter", "reduce_scatter", output)
        if self._inner is not None:
            return self._inner._reduce_scatter_base(output, input, opts)
        part = input.reshape(self._size, -1)[self._rank]
        output.copy_(part.reshape(output.shape))
        if opts is None or opts.reduceOp == ReduceOp.SUM:
            output.mul_(self._size)
        return _done(output)

    reduce_scatter_single = _reduce_scatter_base

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._reduce_scatter_base(o, i, opts).wait()
        return _done(outputs)

    def reduce_scatter(self, outputs, inputs, opts=None):
        for o in outputs:
            self._book("reduce-scatter", "reduce_scatter", o)
        if self._inner is not None:
            return self._inner.reduce_scatter(outputs, inputs, opts)
        for o, parts in zip(outputs, inputs):
            o.copy_(parts[self._rank])
            if opts is None or opts.reduceOp == ReduceOp.SUM:
                o.mul_(self._size)
        return _done(outputs)

    # -- gathers ------------------------------------------------------------
    def _allgather_base(self, output, input, opts=None):
        self._book("all-gather", "all_gather", output)
        if self._inner is not None:
            return self._inner._allgather_base(output, input, opts)
        output.copy_(input.reshape(1, -1).expand(self._size, -1).reshape(
            output.shape))
        return _done(output)

    all_gather_single = _allgather_base

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._allgather_base(o, i, opts).wait()
        return _done(outputs)

    def allgather(self, outputs, inputs, opts=None):
        for outs in outputs:
            for o in outs:
                self._book("all-gather", "all_gather", o)
        if self._inner is not None:
            return self._inner.allgather(outputs, inputs, opts)
        for outs, i in zip(outputs, inputs):
            for o in outs:
                o.copy_(i)
        return _done(outputs)

    def broadcast(self, tensors, opts=None):
        for t in tensors:
            self._book("broadcast", "broadcast", t)
        if self._inner is not None:
            return self._inner.broadcast(tensors, opts)
        return _done(tensors)

    # -- all-to-all ---------------------------------------------------------
    def alltoall_base(self, output, input, output_splits, input_splits,
                      opts=None):
        self._book("all-to-all", "all_to_all", output)
        if self._inner is not None:
            return self._inner.alltoall_base(output, input, output_splits,
                                              input_splits, opts)
        n = self._size
        ins = (list(input.split(list(input_splits))) if input_splits
               else list(input.chunk(n)))
        outs = (list(output.split(list(output_splits))) if output_splits
                else list(output.chunk(n)))
        for o in outs:                 # each peer sends what it sends us
            o.copy_(ins[self._rank].reshape(o.shape))
        return _done(output)

    all_to_all_single = alltoall_base

    def alltoall(self, outputs, inputs, opts=None):
        for o in outputs:
            self._book("all-to-all", "all_to_all", o)
        if self._inner is not None:
            return self._inner.alltoall(outputs, inputs, opts)
        for o in outputs:
            o.copy_(inputs[self._rank])
        return _done(outputs)

    # -- point to point, barrier ---------------------------------------------
    def send(self, tensors, dst, tag=0):
        for t in tensors:
            self._book("collective-permute", "send", t)
        if self._inner is not None:
            return self._inner.send(tensors, dst, tag)
        return _done(tensors)

    def recv(self, tensors, src, tag=0):
        for t in tensors:
            self._book("collective-permute", "recv", t)
        if self._inner is not None:
            return self._inner.recv(tensors, src, tag)
        return _done(tensors)

    def barrier(self, opts=None):
        if self._inner is not None:
            return self._inner.barrier(opts)
        return _done()


def _create(store, rank, size, timeout):
    inner = None
    if _INNER.get("inner") == "gloo":
        inner = dist.ProcessGroupGloo(store, rank, size, timeout)
    return BookedGroup(rank, size, inner)


_registered = False


def init_booked(rank: int, world_size: int, *, real: bool,
                init_method: str | None = None, store=None,
                timeout: float = 300.0) -> None:
    """Start the default group on the ``"booked"`` backend: over ``gloo``
    (``real``; ``init_method`` or ``store`` as for ``init_process_group``)
    or dry (no other process: a ``FakeStore``, rank 0 of ``world_size``
    unless given).  Every group a ``DeviceMesh`` makes from it is booked
    too."""
    global _registered
    if not _registered:
        dist.Backend.register_backend("booked", _create,
                                      devices=["cpu", "cuda"])
        _registered = True
    _INNER["inner"] = "gloo" if real else None
    if not real and store is None and init_method is None:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = FakeStore()
    dist.init_process_group("booked", init_method=init_method, store=store,
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))


def by_kind(book: list) -> dict:
    """{kind: {"count", "bytes"}} over the reference's kinds (and any
    other kind booked, a broadcast): the reference dry-run's ring model,
    an all-reduce's bytes twice its result's."""
    out = {k: {"count": 0, "bytes": 0} for k in KINDS}
    for c in book:
        row = out.setdefault(c["kind"], {"count": 0, "bytes": 0})
        row["count"] += 1
        row["bytes"] += c["bytes"] * (2 if c["kind"] == "all-reduce" else 1)
    return out
