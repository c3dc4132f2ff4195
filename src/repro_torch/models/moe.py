"""Mixture-of-Experts on one device: the plan and the weights (port of the
single-device part of ``models/moe.py``).

When ``E < tp`` (grok-1: 8 experts on a 16-wide model axis) each expert is
split along d_ff into ``r = tp / E`` *virtual experts*, an exact
decomposition of the (gated) FFN: the partial down-projections sum.  The
weights are stored in that virtual layout, ``w1``/``w3`` [Ev, D, Fv] and
``w2`` [Ev, Fv, D], so trees carried across from JAX keep their shapes.

The routing itself on one device is ``transformer.moe_local_reference``,
the dense one-hot reference JAX runs when there is no mesh.  The
expert-parallel path (``_route_and_pack``, ``_unpack_combine``,
``moe_block_local``, ``moe_apply``: capacity buffers exchanged by an
``all_to_all`` over the model axis) is a sharding layer and is not ported
here (ROADMAP queue 1 item 16), nor is the plan's capacity arithmetic
(``capacity_factor``, ``per_rank_slots``, ``kr``, ``capacity``), which
only that path reads.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.models.layers import normal


@dataclass(frozen=True)
class MoEPlan:
    num_experts: int       # E (logical)
    top_k: int
    tp: int
    d_model: int
    d_ff: int              # logical per-expert width

    @property
    def virt_per_expert(self) -> int:
        return max(1, self.tp // self.num_experts) if self.num_experts < self.tp else 1

    @property
    def virtual_experts(self) -> int:
        return self.num_experts * self.virt_per_expert

    @property
    def d_ff_virtual(self) -> int:
        return self.d_ff // self.virt_per_expert


def plan_moe(cfg, tp: int) -> MoEPlan:
    if cfg.num_experts >= tp and cfg.num_experts % tp:
        raise ValueError(f"num_experts={cfg.num_experts} not divisible by tp={tp}")
    if cfg.num_experts < tp and tp % cfg.num_experts:
        raise ValueError(f"tp={tp} not divisible by num_experts={cfg.num_experts}")
    if cfg.num_experts < tp and cfg.d_ff % (tp // cfg.num_experts):
        raise ValueError("d_ff not divisible by virtual split")
    return MoEPlan(
        num_experts=cfg.num_experts, top_k=cfg.experts_per_token, tp=tp,
        d_model=cfg.d_model, d_ff=cfg.d_ff,
    )


class MoE(nn.Module):
    """The JAX ``moe_init`` dict as parameters: ``router`` [D, E] in f32,
    ``w1`` [Ev, D, Fv], ``w2`` [Ev, Fv, D] and, gated, ``w3`` [Ev, D, Fv]
    in the model's dtype."""

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
        never alive at once."""
        plan = self.plan
        s_in, s_out = 1.0 / math.sqrt(plan.d_model), 1.0 / math.sqrt(plan.d_ff)
        self.router.copy_(normal(tuple(self.router.shape), s_in, gen, torch.float32))
        for w, s in ((self.w1, s_in), (self.w2, s_out), (self.w3, s_in)):
            if w is None:
                continue
            for e in range(w.shape[0]):
                w[e].copy_(normal(tuple(w.shape[1:]), s, gen, w.dtype))
        return self
