"""Shard transports — how the shards of a runtime exchange data.

Two implementations behind one small interface, both driven by the same
shard loops (``runtime/shard_runtime.py:_make_loop``,
``solvers/fixed_point.py:make_sharded_solver``):

* ``StackedTransport`` — all ``p`` shards live in one process on one
  device; a message is a reference to the sender's tensor and a reduction a
  sum/max over the stacked lanes (the JAX package's ``psum``/``pmax``).
* ``GroupTransport`` — one shard per rank of a ``torch.distributed``
  process group (``launch.mesh.ShardGroup``, gloo or NCCL).

Every shard is keyed by its row-major rank; a transport's ``local`` shards
are all ``p`` of them (stacked) or the rank's own (group).  The operations,
each taking and returning ``{shard: value}`` maps over the local shards:

* ``reduce(lanes, ord) -> Pending`` — the pre-σ sum or max of the lanes.
  Over a group it is ``dist.all_reduce(..., async_op=True)``, waited only
  at the check that consumes it, K checks later (``ReductionPipeline``):
  the paper's ``MPI_Iallreduce``.
* ``exact(contribs, ord) -> Tensor`` — σ of a blocking reduction (NFAIS2's
  verification), issued on every rank.
* ``route(sends) -> Pending`` — point-to-point messages.  ``sends[i]``
  maps ``(j, key)`` to the tensor shard i sends shard j; the pattern is
  symmetric (j sends i a tensor of the same shape under the same key), and
  the result maps ``(j, key)`` to what shard i received from j.  Face
  planes and recursive doubling's XOR-partner round go through it, over a
  group as one ``batch_isend_irecv``.
* ``all_gather(blocks) -> list`` — every shard's block, in rank order.

Every rank issues the same collectives in the same order; per-shard knobs
change local work only.  Under gloo a CUDA tensor is staged through host
memory explicitly: the producing stream is synchronised, the tensor copied
to the host, sent, and the received copy moved back to the card; the group
counts the bytes staged.  Under NCCL (and for CPU tensors) tensors go as
they are.  The group also sums the host seconds spent staging (the stream
synchronisation included, so on a card that ranks share it holds the wait
for the other ranks' kernels) and blocked in transfers.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, Hashable, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import residual as res

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

    def route(self, sends: Msgs) -> Pending:
        recvs: Msgs = {i: {} for i in self.local}
        for j, msgs in sends.items():
            for (i, key), t in msgs.items():
                recvs[i][j, key] = t
        return Pending.done(recvs)

    def all_gather(self, blocks: Dict[int, torch.Tensor]) -> List[torch.Tensor]:
        return [blocks[i] for i in self.local]


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
        """Fresh contiguous wire copies of ``tensors``: on the host under
        gloo (after the producing stream is synchronised), else as they
        lie."""
        if not self._staged or not tensors:
            return [t.clone(memory_format=torch.contiguous_format) for t in tensors]
        t0 = time.perf_counter()
        torch.cuda.current_stream(self.device).synchronize()
        host = [t.to("cpu", copy=True).contiguous() for t in tensors]
        self.group.staged_bytes += sum(h.nbytes for h in host)
        self.group.staged_s += time.perf_counter() - t0
        return host

    def _in(self, t: torch.Tensor) -> torch.Tensor:
        """A received wire tensor on the shard's device."""
        if not self._staged:
            return t
        t0 = time.perf_counter()
        out = t.to(self.device)
        self.group.staged_bytes += t.nbytes
        self.group.staged_s += time.perf_counter() - t0
        return out

    def _wait(self, works: Sequence) -> None:
        t0 = time.perf_counter()
        for w in works:
            w.wait()
        self.group.wait_s += time.perf_counter() - t0

    def _own(self, vals: Dict[int, torch.Tensor]) -> torch.Tensor:
        (v,) = vals.values()
        return v

    def reduce(self, lanes: Dict[int, torch.Tensor], ord: float) -> Pending:
        (wire,) = self._out([self._own(lanes).reshape(1)])
        work = dist.all_reduce(wire, op=self._op(ord), async_op=True)
        return Pending(lambda: self._wait([work]) or self._in(wire).reshape(()))

    def exact(self, contribs: Dict[int, torch.Tensor], ord: float) -> torch.Tensor:
        (wire,) = self._out([self._own(contribs).reshape(1)])
        self._wait([dist.all_reduce(wire, op=self._op(ord), async_op=True)])
        return res.sigma(self._in(wire), ord)

    def route(self, sends: Msgs) -> Pending:
        msgs = self._own(sends)
        keys = list(msgs)
        wires = self._out([msgs[k] for k in keys])
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


def make_transport(p, device: torch.device):
    """The transport of ``p``: a ``ShardGroup`` (one shard per rank), or a
    shard count (all shards stacked on ``device``)."""
    if hasattr(p, "backend"):
        return GroupTransport(p)
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
