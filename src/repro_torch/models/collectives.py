"""The collectives of the model's parallel layout, with their gradients.

A port-only helper: the JAX package writes no collective for its dense
layers, since GSPMD inserts them from the sharding specs, and writes its
MoE exchange under ``shard_map``.  Here every rank runs its own part of
the model, so the collectives are explicit.  Each is a
``torch.autograd.Function`` over one axis (or a tuple of axes) of a
``launch.mesh.ModelMesh``, with the rule every rank follows: an activation
that is replicated over an axis carries its full gradient on every rank.

* ``copy_to``: identity, all-reduce of the gradient (Megatron's f), where a
  replicated activation enters a layer whose ranks each take a part;
* ``reduce_from``: all-reduce, identity gradient (Megatron's g), where the
  parts' partial sums become a replicated activation;
* ``gather_rs``: all-gather along a dimension, reduce-scatter of the
  gradient, where each rank computes a partial result from the whole
  (JAX's ``all_gather``, whose transpose is ``psum_scatter``);
* ``gather_split``: all-gather into a replicated activation, the
  gradient's own block kept;
* ``scatter_sum``: reduce-scatter (JAX's ``psum_scatter``), all-gather of
  the gradient;
* ``all_to_all``: block i of dim 0 to rank i; its gradient goes back by the
  same exchange.

Under gloo a CUDA tensor goes through host memory as the shard transport
stages it (``runtime/transport.py:stage_out`` / ``stage_in``), counted in
the mesh's ``staged_bytes`` / ``staged_s``; the host seconds blocked in a
collective go to ``wait_s``, and each kind's payload bytes and host
seconds to ``moved_bytes`` / ``moved_s`` (``ModelMesh.count``).  An axis of
size 1 is the identity and moves nothing.  On a dry rank
(``launch.mesh.dry_rank``, backend ``"dry"``) a collective needs no process
group: it returns an empty ``meta`` tensor of its result's shape and
counts its payload through the same ``count`` as a live one.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.core import compat
from repro_torch.runtime.transport import stage_in, stage_out


def _trivial(mesh, axis) -> bool:
    return mesh is None or mesh.size(axis) == 1


def _collective(mesh, kind: str, axis, x: torch.Tensor, out_shape, op) -> torch.Tensor:
    """Run ``op(out_wire, in_wire, group)`` over the axis' group on a staged
    copy of ``x`` and return the result on ``x``'s device; on a dry rank,
    an empty ``meta`` result.  Either way the payload is counted."""
    k = mesh.size(axis)
    if mesh.backend == "dry":
        mesh.count(kind, x.nbytes, 0.0, k)
        return torch.empty(out_shape, dtype=x.dtype, device="meta")
    g = mesh.group(axis)
    staged = mesh.backend == "gloo" and x.is_cuda
    t0 = time.perf_counter()
    (wire,) = stage_out(mesh, staged, x.device, [x.contiguous()])
    out = torch.empty(out_shape, dtype=wire.dtype, device=wire.device)
    t1 = time.perf_counter()
    op(out, wire, g)
    mesh.wait_s += time.perf_counter() - t1
    res = stage_in(mesh, staged, x.device, out)
    mesh.count(kind, x.nbytes, time.perf_counter() - t0, k)
    return res


def all_reduce(x: torch.Tensor, mesh, axis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of ``x`` over the axis, on every rank."""
    if _trivial(mesh, axis):
        return x

    def run(out, wire, g):
        out.copy_(wire)
        dist.all_reduce(out, op=op, group=g)

    return _collective(mesh, "all_reduce", axis, x, x.shape, run)


def all_gather(x: torch.Tensor, mesh, axis, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in rank order."""
    if _trivial(mesh, axis):
        return x
    k = mesh.size(axis)
    xm = x.movedim(dim, 0)
    stacked = _collective(mesh, "all_gather", axis, xm,
                          (k * xm.shape[0],) + tuple(xm.shape[1:]),
                          lambda out, wire, g: compat.all_gather_into_tensor(out, wire, g))
    return stacked.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, mesh, axis, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over the axis."""
    if _trivial(mesh, axis):
        return x
    k = mesh.size(axis)
    xm = x.movedim(dim, 0)
    if xm.shape[0] % k:
        raise ValueError(f"dimension {dim} ({x.shape[dim]}) does not split over {k} ranks")
    out = _collective(mesh, "reduce_scatter", axis, xm,
                      (xm.shape[0] // k,) + tuple(xm.shape[1:]),
                      lambda out, wire, g: compat.reduce_scatter_tensor(out, wire, g))
    return out.movedim(0, dim)


def exchange(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``x`` [k, …]: block i goes to rank i; block j of the result came
    from rank j."""
    if _trivial(mesh, axis):
        return x
    if x.shape[0] != mesh.size(axis):
        raise ValueError(f"all_to_all over {mesh.size(axis)} ranks of a tensor {tuple(x.shape)}")
    return _collective(mesh, "all_to_all", axis, x, x.shape,
                       lambda out, wire, g: dist.all_to_all_single(out, wire, group=g))


def _block(x: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    k = mesh.size(axis)
    n = x.shape[dim] // k
    return x.narrow(dim, mesh.index(axis) * n, n).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherRS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return exchange(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return exchange(g.contiguous(), ctx.mesh, ctx.axis), None, None


def copy_to(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    return x if _trivial(mesh, axis) else _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    return x if _trivial(mesh, axis) else _ReduceFrom.apply(x, mesh, axis)


def gather_rs(x: torch.Tensor, mesh, axis, dim: int = 0) -> torch.Tensor:
    return x if _trivial(mesh, axis) else _GatherRS.apply(x, mesh, axis, dim)


def gather_split(x: torch.Tensor, mesh, axis, dim: int = 0) -> torch.Tensor:
    return x if _trivial(mesh, axis) else _GatherSplit.apply(x, mesh, axis, dim)


def scatter_sum(x: torch.Tensor, mesh, axis, dim: int = 0) -> torch.Tensor:
    return x if _trivial(mesh, axis) else _ScatterSum.apply(x, mesh, axis, dim)


def all_to_all(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    return x if _trivial(mesh, axis) else _AllToAll.apply(x, mesh, axis)
