"""Shard transports — how the shards of a runtime exchange data.

Two implementations behind one small interface, both driven by the same
shard loops (``runtime/shard_runtime.py:_make_loop``,
``solvers/fixed_point.py:make_sharded_solver``):

* ``StackedTransport`` — all ``p`` shards live in one process on one
  device; a message is a reference to the sender's tensor and a reduction a
  sum/max over the stacked lanes (the JAX package's ``psum``/``pmax``).
* ``GroupTransport`` — one shard per rank of a ``torch.distributed``
  process group (``launch.mesh.ShardGroup``, gloo or NCCL); on a dry
  group (``launch.mesh.dry_shard_group``, ``meta``) a ``DryTransport``,
  which moves nothing and counts each collective as XLA's SPMD program
  would hold it.

Every shard is keyed by its row-major rank; a transport's ``local`` shards
are all ``p`` of them (stacked) or the rank's own (group).  The operations,
each taking and returning ``{shard: value}`` maps over the local shards:

* ``reduce(lanes, ord) -> Pending`` — the pre-σ sum or max of the lanes.
  Over a group it is ``dist.all_reduce(..., async_op=True)``, waited only
  at the check that consumes it, K checks later (``ReductionPipeline``):
  the paper's ``MPI_Iallreduce``.
* ``exact(contribs, ord) -> Tensor`` — σ of a blocking reduction (NFAIS2's
  verification), issued on every rank.
* ``route(sends, permutes=None) -> Pending`` — point-to-point messages.
  ``sends[i]`` maps ``(j, key)`` to the tensor shard i sends shard j; the
  pattern is symmetric (j sends i a tensor of the same shape under the
  same key), and the result maps ``(j, key)`` to what shard i received
  from j.  Face planes and recursive doubling's XOR-partner round go
  through it, over a group as one ``batch_isend_irecv``.  ``permutes`` is
  the number of shift directions of the exchange, which only a dry
  transport reads (default: one a message).
* ``all_gather(blocks) -> list`` — every shard's block, in rank order.

``replica_mean`` averages equal-shaped blocks over the shards (the JAX
package's ``pmean``) from an all-gather, on either transport.

Every rank issues the same collectives in the same order; per-shard knobs
change local work only.  Under gloo a CUDA tensor is staged through host
memory explicitly: the producing stream is synchronised, the tensor copied
to the host, sent, and the received copy moved back to the card; the group
counts the bytes staged.  Under NCCL (and for CPU tensors) tensors go as
they are.  The group also sums the host seconds spent staging (the stream
synchronisation included, so on a card that ranks share it holds the wait
for the other ranks' kernels) and blocked in transfers.

While a span recorder is open (``core/spans.py``) a live group counts
what its loop puts on the wire: ``wire_bytes``, the payload bytes this
rank hands to the backend (each reduction's lane, each message a route
sends; the result's ``all_gather`` is not counted), and ``collectives``,
each backend operation it launches (an ``all_reduce``, each ``isend`` and
each ``irecv`` of a batch).  A dry group counts in its ``calls`` instead.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, Hashable, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import residual as res
from repro_torch.core import spans

Msgs = Dict[int, Dict[Tuple[int, Hashable], torch.Tensor]]


class Pending:
    """A result in flight: ``wait()`` runs ``finish`` (which completes the
    transfers) and returns its value, once; later calls return the same
    value."""

    def __init__(self, finish: Callable[[], object]):
        self._finish, self._done, self._value = finish, False, None

    @classmethod
    def done(cls, value) -> "Pending":
        return cls(lambda: value)

    def wait(self):
        if not self._done:
            self._value, self._done = self._finish(), True
        return self._value

    def then(self, fn: Callable) -> "Pending":
        """The pending result of ``fn`` applied to this one's value."""
        return Pending(lambda: fn(self.wait()))


def _preduce(lanes: torch.Tensor, ord: float) -> torch.Tensor:
    """Pre-σ reduction of stacked lanes (sum / max); σ is applied where the
    value is consumed."""
    return lanes.amax() if np.isinf(ord) else lanes.sum()


class StackedTransport:
    """All ``p`` shards in one process on one device."""

    def __init__(self, p: int, device: torch.device):
        self.p, self.device, self.local = p, device, tuple(range(p))

    def _stack(self, vals: Dict[int, torch.Tensor]) -> torch.Tensor:
        return torch.stack([vals[i] for i in self.local])

    def reduce(self, lanes: Dict[int, torch.Tensor], ord: float) -> Pending:
        return Pending.done(_preduce(self._stack(lanes), ord))

    def exact(self, contribs: Dict[int, torch.Tensor], ord: float) -> torch.Tensor:
        return res.psum_sigma(self._stack(contribs), ord)

    def route(self, sends: Msgs, permutes=None) -> Pending:
        recvs: Msgs = {i: {} for i in self.local}
        for j, msgs in sends.items():
            for (i, key), t in msgs.items():
                recvs[i][j, key] = t
        return Pending.done(recvs)

    def all_gather(self, blocks: Dict[int, torch.Tensor]) -> List[torch.Tensor]:
        return [blocks[i] for i in self.local]


def stage_out(counters, staged: bool, device: torch.device,
              tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Fresh contiguous wire copies of ``tensors``: on the host where the
    wire is ``staged`` (gloo with CUDA tensors: the producing stream is
    synchronised, then each tensor copied), else as they lie.  The staged
    bytes and host seconds go to ``counters`` (a ``ShardGroup`` or a
    ``ModelMesh``)."""
    if not staged or not tensors:
        return [t.clone(memory_format=torch.contiguous_format) for t in tensors]
    t0 = time.perf_counter()
    torch.cuda.current_stream(device).synchronize()
    host = [t.to("cpu", copy=True).contiguous() for t in tensors]
    counters.staged_bytes += sum(h.nbytes for h in host)
    counters.staged_s += time.perf_counter() - t0
    return host


def stage_in(counters, staged: bool, device: torch.device, t: torch.Tensor) -> torch.Tensor:
    """A received wire tensor on ``device`` (counted as ``stage_out``)."""
    if not staged:
        return t
    t0 = time.perf_counter()
    out = t.to(device)
    counters.staged_bytes += t.nbytes
    counters.staged_s += time.perf_counter() - t0
    return out


class GroupTransport:
    """One shard per rank of the default process group, which a
    ``ShardGroup`` lays out as a shard mesh (its ranks are the world's)."""

    def __init__(self, group):
        self.group, self.p, self.device = group, group.p, group.device
        self.local = (group.rank,)
        self._staged = group.backend == "gloo" and group.device.type == "cuda"

    def _op(self, ord: float):
        return dist.ReduceOp.MAX if np.isinf(ord) else dist.ReduceOp.SUM

    def _out(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return stage_out(self.group, self._staged, self.device, tensors)

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        return stage_in(self.group, self._staged, self.device, t)

    def _wait(self, works: Sequence) -> None:
        t0 = time.perf_counter()
        for w in works:
            w.wait()
        self.group.wait_s += time.perf_counter() - t0

    def _own(self, vals: Dict[int, torch.Tensor]) -> torch.Tensor:
        (v,) = vals.values()
        return v

    @staticmethod
    def _count(nbytes: int, ops: int) -> None:
        """``nbytes`` of payload and ``ops`` backend operations on the wire
        (``spans.COUNTERS``; nothing without a recorder)."""
        spans.count("wire_bytes", nbytes)
        spans.count("collectives", ops)

    def reduce(self, lanes: Dict[int, torch.Tensor], ord: float) -> Pending:
        (wire,) = self._out([self._own(lanes).reshape(1)])
        self._count(wire.nbytes, 1)
        work = dist.all_reduce(wire, op=self._op(ord), async_op=True)
        return Pending(lambda: self._wait([work]) or self._in(wire).reshape(()))

    def exact(self, contribs: Dict[int, torch.Tensor], ord: float) -> torch.Tensor:
        (wire,) = self._out([self._own(contribs).reshape(1)])
        self._count(wire.nbytes, 1)
        self._wait([dist.all_reduce(wire, op=self._op(ord), async_op=True)])
        return res.sigma(self._in(wire), ord)

    def route(self, sends: Msgs, permutes=None) -> Pending:
        msgs = self._own(sends)
        keys = list(msgs)
        wires = self._out([msgs[k] for k in keys])
        self._count(sum(w.nbytes for w in wires), 2 * len(wires))
        bufs = [torch.empty_like(w) for w in wires]
        ops = []
        for (peer, _), w, b in zip(keys, wires, bufs):
            ops += [dist.P2POp(dist.isend, w, peer),
                    dist.P2POp(dist.irecv, b, peer)]
        works = dist.batch_isend_irecv(ops) if ops else []
        rank = self.group.rank
        return Pending(lambda: self._wait(works) or
                       {rank: {k: self._in(b) for k, b in zip(keys, bufs)}})

    def all_gather(self, blocks: Dict[int, torch.Tensor]) -> List[torch.Tensor]:
        (wire,) = self._out([self._own(blocks)])
        outs = [torch.empty_like(wire) for _ in range(self.p)]
        self._wait([dist.all_gather(outs, wire, async_op=True)])
        return [self._in(o) for o in outs]


class DryTransport(GroupTransport):
    """One shard of a dry group (``launch.mesh.dry_shard_group``): tensors
    are on ``meta``, nothing is staged, sent or waited for, and each call
    counts its collective in the group's ``calls`` as XLA's SPMD program of
    the JAX runtime holds it: a reduction is one ``all_reduce`` of the lane,
    and an exchange one ``collective_permute`` of one message a shift
    direction, whether or not this rank has a peer that way (every device
    takes part in each of the program's permutes; rank 0 of a 1-D chain
    sends one face, and the program has two permutes).  It carries what
    the solver cell runs (``launch/dryrun.py:lower_solver_cell``): its
    ``exact`` and ``all_gather`` are a live group's, which need a process
    group."""

    def reduce(self, lanes: Dict[int, torch.Tensor], ord: float) -> Pending:
        lane = self._own(lanes).reshape(1)
        self.group.count("all_reduce", lane.nbytes, self.p)
        return Pending.done(torch.empty_like(lane).reshape(()))

    def route(self, sends: Msgs, permutes=None) -> Pending:
        msgs = self._own(sends)
        if msgs:
            nbytes = max(t.nbytes for t in msgs.values())
            for _ in range(len(msgs) if permutes is None else permutes):
                self.group.count("collective_permute", nbytes, self.p)
        return Pending.done({self.group.rank: {k: torch.empty_like(t)
                                               for k, t in msgs.items()}})


def replica_mean(transport, blocks: Dict[int, torch.Tensor]) -> torch.Tensor:
    """The mean over all shards of their equal-shaped blocks, on every
    shard: the JAX package's ``pmean``.  An all-gather and a local mean, so
    a group's mean is bitwise its stacked twin's (an ``all_reduce`` would
    sum in an order its backend picks)."""
    return torch.stack(transport.all_gather(blocks)).mean(0)


def make_transport(p, device: torch.device):
    """The transport of ``p``: a ``ShardGroup`` (one shard per rank; a dry
    one counts and moves nothing), or a shard count (all shards stacked on
    ``device``)."""
    if hasattr(p, "backend"):
        return DryTransport(p) if p.backend == "dry" else GroupTransport(p)
    return StackedTransport(int(p), device)


class ReductionPipeline:
    """The reductions in flight, K deep: the one launched at check k is
    waited for, and consumed, at check k + K; before that a check sees +∞
    (the primed ring of ``core.detection``).  Trace slot k holds σ of the
    reduction launched at check k, filled when it is waited for; ``drain``
    waits for every reduction still outstanding."""

    def __init__(self, staleness: int, ord: float, trace_len: int,
                 device: torch.device):
        self.K, self.ord = int(staleness), ord
        self.inf = torch.full((), float("inf"), dtype=torch.float32, device=device)
        self.trace = [self.inf] * max(int(trace_len), 1)
        self.inflight: deque = deque()
        self.launched = 0

    def launch(self, pending: Pending) -> None:
        self.inflight.append((self.launched, pending))
        self.launched += 1

    def _wait_oldest(self) -> torch.Tensor:
        k, pending = self.inflight.popleft()
        g = res.sigma(pending.wait(), self.ord).to(torch.float32)
        if k < len(self.trace):
            self.trace[k] = g
        return g

    def consume(self) -> torch.Tensor:
        """The visible value of this check (σ applied, f32)."""
        return self._wait_oldest() if len(self.inflight) > self.K else self.inf

    def drain(self) -> torch.Tensor:
        """Wait for every outstanding reduction; the f32 trace."""
        while self.inflight:
            self._wait_oldest()
        return torch.stack(self.trace)
