"""Mixture-of-Experts with explicit expert parallelism (port of
``models/moe.py``).

Layout
------
Experts are sharded over the ``model`` axis.  When ``E < tp`` (grok-1: 8
experts on a 16-wide axis) each expert is split along d_ff into ``r = tp /
E`` *virtual experts*, an exact decomposition of the (gated) FFN: the
partial down-projections sum, so every rank owns ``ps = E_v / tp ≥ 1``
expert shards.  The weights are stored in that virtual layout, ``w1`` /
``w3`` [Ev, D, Fv] and ``w2`` [Ev, Fv, D] (a rank holds its ``ps`` of
them), so trees carried across from JAX keep their shapes.

``moe_apply`` is the expert-parallel path: the tokens of a data shard are
split over ``model``, routed top-k (``_route_and_pack``) into per-(rank,
slot) capacity buffers ``[Ev, C, D]`` (entries past the capacity go to an
overflow row and are dropped), exchanged with one ``all_to_all``,
transformed by the rank's experts, and returned with a second
``all_to_all`` (``_unpack_combine``).  Over ``data`` the expert d_ff is
split too (expert-TP): the received tokens are all-gathered over ``data``,
each rank runs the partial FFN on its d_ff block, and the partial
down-projections are reduce-scattered back.  JAX runs the body under
``shard_map``; here each rank runs ``moe_block_local`` with the
collectives of ``models/collectives.py``.  Everything has static shapes
and is differentiable (an ``all_to_all``'s gradient is the reverse
exchange).  Without a mesh the model runs
``transformer.moe_local_reference``, the dense one-hot path JAX runs with
no mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import collectives as col
from repro_torch.models.layers import ceil_to, fill_, normal


@dataclass(frozen=True)
class MoEPlan:
    num_experts: int       # E (logical)
    top_k: int
    tp: int
    d_model: int
    d_ff: int              # logical per-expert width
    capacity_factor: float = 1.0

    @property
    def virt_per_expert(self) -> int:
        return max(1, self.tp // self.num_experts) if self.num_experts < self.tp else 1

    @property
    def virtual_experts(self) -> int:
        return self.num_experts * self.virt_per_expert

    @property
    def d_ff_virtual(self) -> int:
        return self.d_ff // self.virt_per_expert

    @property
    def per_rank_slots(self) -> int:
        return self.virtual_experts // self.tp

    @property
    def kr(self) -> int:
        return self.top_k * self.virt_per_expert

    def capacity(self, tokens_per_rank: int) -> int:
        c = math.ceil(self.capacity_factor * tokens_per_rank * self.kr / self.virtual_experts)
        return max(1, c)


def plan_moe(cfg, tp: int, capacity_factor: float = 1.0) -> MoEPlan:
    if cfg.num_experts >= tp and cfg.num_experts % tp:
        raise ValueError(f"num_experts={cfg.num_experts} not divisible by tp={tp}")
    if cfg.num_experts < tp and tp % cfg.num_experts:
        raise ValueError(f"tp={tp} not divisible by num_experts={cfg.num_experts}")
    if cfg.num_experts < tp and cfg.d_ff % (tp // cfg.num_experts):
        raise ValueError("d_ff not divisible by virtual split")
    return MoEPlan(
        num_experts=cfg.num_experts, top_k=cfg.experts_per_token, tp=tp,
        d_model=cfg.d_model, d_ff=cfg.d_ff, capacity_factor=capacity_factor,
    )


class MoE(nn.Module):
    """The JAX ``moe_init`` dict as parameters: ``router`` [D, E] in f32,
    ``w1`` [Ev, D, Fv], ``w2`` [Ev, Fv, D] and, gated, ``w3`` [Ev, D, Fv]
    in the model's dtype (a rank of a mesh holds its block of each:
    ``Model.param_specs``)."""

    def __init__(self, plan: MoEPlan, gated: bool, dtype: torch.dtype, device=None):
        super().__init__()
        self.plan = plan
        Ev, D, Fv = plan.virtual_experts, plan.d_model, plan.d_ff_virtual

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.router = param(D, plan.num_experts, dt=torch.float32)
        self.w1 = param(Ev, D, Fv)
        self.w2 = param(Ev, Fv, D)
        self.w3 = param(Ev, D, Fv) if gated else None

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "MoE":
        """The JAX ``moe_init``'s distributions: N(0, 1/D) router and input
        projections, N(0, 1/d_ff) down-projections (d_ff the logical
        width).  Each expert slice is drawn in f32 and cast on its own, so
        the f32 draw of a whole stack (21.5 GB for llama4's ``w1``) is
        never alive at once; a rank of a mesh draws every slice, in the
        same order, and keeps its own experts' blocks."""
        plan = self.plan
        s_in, s_out = 1.0 / math.sqrt(plan.d_model), 1.0 / math.sqrt(plan.d_ff)
        fill_(self.router, normal((plan.d_model, plan.num_experts), s_in, gen, torch.float32))
        Ev, D, Fv = plan.virtual_experts, plan.d_model, plan.d_ff_virtual
        for w, s, shape in ((self.w1, s_in, (D, Fv)), (self.w2, s_out, (Fv, D)),
                            (self.w3, s_in, (D, Fv))):
            if w is None:
                continue
            block = getattr(w, "local", None) or (slice(0, Ev),)
            experts, rest = block[0], block[1:]
            for e in range(Ev):
                draw = normal(shape, s, gen, w.dtype)
                if experts.start <= e < experts.stop:
                    w[e - experts.start].copy_(draw[rest] if rest else draw)
        return self


# ---------------------------------------------------------------------------
# Routing / packing (runs per model-rank on its token slice)
# ---------------------------------------------------------------------------


def _route_and_pack(tokens: torch.Tensor, router_w: torch.Tensor, plan: MoEPlan,
                    capacity: int, valid_mask: torch.Tensor):
    """tokens [t, D] → (send [Ev, C, D], combine info, aux).

    combine info: slots [t, kr], pos [t, kr], weights [t, kr] (0 if
    dropped).  Capacity positions count the entries before each one in
    (slot, token) order; an entry past the capacity lands in the overflow
    row C, which is cut off (``index_put`` with ``accumulate=True`` where
    JAX adds with ``mode="drop"``)."""
    t, D = tokens.shape
    Ev, r, kr = plan.virtual_experts, plan.virt_per_expert, plan.kr
    logits = torch.einsum("td,de->te", tokens.float(), router_w)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, plan.top_k, dim=-1)          # [t, k]
    # virtual expansion: expert e → slots e*r .. e*r+r-1, same weight each
    slots = (topi[:, :, None] * r
             + torch.arange(r, device=tokens.device)[None, None, :]).reshape(t, kr)
    weights = topv.repeat_interleave(r, dim=-1) * valid_mask[:, None]   # [t, kr]
    flat_slot = slots.reshape(-1)                                # [t*kr]
    active = weights.reshape(-1) > 0.0
    onehot = F.one_hot(flat_slot, Ev).to(torch.int32) * active[:, None].to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot   # count before me
    flat_pos = (pos * onehot).sum(dim=1)                         # [t*kr]
    keep = active & (flat_pos < capacity)
    sp = torch.where(keep, flat_pos, capacity).long()
    token_rep = tokens.repeat_interleave(kr, dim=0)              # [t*kr, D]
    send = torch.zeros((Ev, capacity + 1, D), dtype=tokens.dtype, device=tokens.device)
    send = send.index_put((flat_slot, sp), token_rep, accumulate=True)[:, :capacity, :]
    pos2 = flat_pos.reshape(t, kr)
    w2 = torch.where(keep.reshape(t, kr), weights, 0.0)
    aux = _load_balance_loss(probs, topi, plan)
    return send, (slots, pos2, w2), aux


def _load_balance_loss(probs: torch.Tensor, topi: torch.Tensor, plan: MoEPlan) -> torch.Tensor:
    """Switch-style aux loss: E · Σ_e f_e · P_e (per-rank partial)."""
    E = plan.num_experts
    f = F.one_hot(topi[:, 0], E).float().mean(dim=0)
    return E * (f * probs.mean(dim=0)).sum()


def _unpack_combine(out_buf: torch.Tensor, info, capacity: int) -> torch.Tensor:
    """out_buf [Ev, C, D] + combine info → token outputs [t, D]."""
    slots, pos, w = info
    t, kr = slots.shape
    pos_c = torch.clamp_max(pos, capacity - 1).long()
    gathered = out_buf[slots.reshape(-1), pos_c.reshape(-1)].reshape(t, kr, -1)
    return torch.einsum("tkd,tk->td", gathered.float(), w).to(out_buf.dtype)


# ---------------------------------------------------------------------------
# The expert-parallel block
# ---------------------------------------------------------------------------


def _ffn(x: torch.Tensor, w1, w2, w3, gated: bool) -> torch.Tensor:
    h = torch.einsum("xpcd,pdf->xpcf", x, w1)
    if gated:
        h = F.silu(h) * torch.einsum("xpcd,pdf->xpcf", x, w3)
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return torch.einsum("xpcf,pfd->xpcd", h, w2)


def _expert_blocks(weights: MoE, plan: MoEPlan, mesh, fsdp_axis: Optional[str]):
    """This rank's expert weights, each cut to its d_ff block over
    ``fsdp_axis`` where they are stored whole (``fsdp`` off): the
    expert-TP split ``moe_apply``'s layout asks for."""
    ws = [weights.w1, weights.w2, weights.w3]
    k = mesh.size(fsdp_axis) if fsdp_axis is not None else 1
    if k == 1 or weights.w1.shape[-1] != plan.d_ff_virtual:
        return ws
    i, n = mesh.index(fsdp_axis), plan.d_ff_virtual // k
    return [None if w is None else w.narrow(2 if j != 1 else 1, i * n, n)
            for j, w in enumerate(ws)]


def moe_block_local(
    x_block: torch.Tensor,       # [b, S, D]: this data shard's tokens (replicated over model)
    weights: MoE,                # this rank's blocks (see the specs in model.py)
    plan: MoEPlan,
    gated: bool,
    mesh,
    model_axis: str = "model",
    fsdp_axis: Optional[str] = "data",
):
    """One rank's part of the expert-parallel MoE.  Returns (y_block
    [b, S, D], aux loss averaged over the model axis)."""
    b, S, D = x_block.shape
    tp = plan.tp
    if mesh.size(model_axis) != tp:
        raise ValueError(f"the plan is for tp={tp}; the mesh's {model_axis!r} axis has "
                         f"{mesh.size(model_axis)} ranks")
    rank = mesh.index(model_axis) if tp > 1 else 0
    x_block = col.copy_to(x_block, mesh, model_axis)
    tokens_all = x_block.reshape(b * S, D)
    T = b * S
    t_pad = ceil_to(max(T, tp), tp)
    tpr = t_pad // tp  # tokens per model-rank
    if t_pad > T:
        tokens_all = F.pad(tokens_all, (0, 0, 0, t_pad - T))
    my = tokens_all[rank * tpr:(rank + 1) * tpr]
    valid = (rank * tpr + torch.arange(tpr, device=x_block.device)) < T

    C = plan.capacity(tpr)
    router = col.copy_to(weights.router, mesh, model_axis)
    send, info, aux = _route_and_pack(my, router, plan, C, valid.float())
    if mesh.moe_drops is not None:
        routed = valid.sum() * plan.kr
        mesh.moe_drops.append((routed - (info[2] > 0).sum(), routed))
    ps = plan.per_rank_slots
    recv = col.all_to_all(send.reshape(tp, ps, C, D), mesh, model_axis)
    # recv [tp(src), ps, C, D]; local expert shards [ps, D, Fv(/data)]
    w1, w2, w3 = _expert_blocks(weights, plan, mesh, fsdp_axis)
    if fsdp_axis is not None and mesh.size(fsdp_axis) > 1:
        # expert-TP over the fsdp axis: d_ff is split over "data", so the
        # *tokens* are all-gathered (cheap) instead of the expert weights,
        # each rank runs the partial FFN on its d_ff block, and the
        # partial down-projections are reduce-scattered back
        xg = col.gather_rs(recv, mesh, fsdp_axis, 0)                 # [dp·tp, ps, C, D]
        out = col.scatter_sum(_ffn(xg, w1, w2, w3, gated), mesh, fsdp_axis, 0)
    else:
        out = _ffn(recv, w1, w2, w3, gated)
    back = col.all_to_all(out, mesh, model_axis)
    y_my = _unpack_combine(back.reshape(plan.virtual_experts, C, D), info, C)
    # reassemble the full token set on every model-rank
    y_all = col.gather_split(y_my, mesh, model_axis, 0)              # [t_pad, D]
    y = y_all[:T].reshape(b, S, D)
    aux = col.reduce_from(aux, mesh, model_axis) / tp
    return y, aux


def moe_apply(
    x: torch.Tensor,             # [b, S, D]: this rank's batch rows
    weights: MoE,
    plan: MoEPlan,
    gated: bool,
    mesh,
    dp_axes: Tuple[str, ...],
    model_axis: str = "model",
    fsdp_axis: Optional[str] = "data",
):
    """The expert-parallel MoE on this rank's rows; returns (y, aux).

    The aux loss is the mean over every (data, model) token slice.  JAX's
    ``shard_map`` declares it replicated (``out_specs=P()``) although each
    data shard computes its own: reading it gives data shard 0's value,
    and its gradient is the mean's (ROADMAP Queue 3)."""
    if fsdp_axis is not None and fsdp_axis not in mesh.axis_names:
        fsdp_axis = None
    y, aux = moe_block_local(x, weights, plan, gated, mesh, model_axis, fsdp_axis)
    dp = tuple(a for a in dp_axes if mesh.size(a) > 1)
    if dp:
        aux = col.reduce_from(aux, mesh, dp) / mesh.size(dp)
    return y, aux
