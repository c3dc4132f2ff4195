"""AdamW + schedules (port of ``optim/adamw.py``), written on tensors.

The update is the JAX package's, step by step: clip by the global norm,
compute in f32 whatever the moment dtype (``moment_dtype=None`` means the
parameter's dtype), bias-correct with ``b1 ** step``, ``delta = m̂/(√v̂ +
eps) + wd·p``, and cast the update to the parameter dtype.
``torch.optim.AdamW`` computes in the moment dtype and does not clip, so it
is not this update.  The clip scale, the learning rate of the step tensor
and the bias corrections stay on the parameters' device: nothing here
reads a value on the host, so a step never waits for the card.

A tree is a tensor, or a dict, list or tuple of trees; dicts are taken in
sorted key order, as JAX flattens them, so ``global_norm`` sums the
leaves in JAX's order.  A model's parameters enter as the dict of its
``named_parameters()``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.layers import dtype_of


class AdamState(NamedTuple):
    step: torch.Tensor     # i32 — updates taken
    m: Any
    v: Any


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of ``tree`` in JAX's order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves):
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in ``tree``'s structure,
    visiting the leaves in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(out) if type(tree) in (list, tuple) else type(tree)(*out)
    return fn(tree, *rest)


@dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: Optional[str] = None   # None => param dtype; "bfloat16"/"float32"

    def _mdtype(self, p: torch.Tensor) -> torch.dtype:
        return dtype_of(self.moment_dtype) if self.moment_dtype else p.dtype

    def init(self, params) -> AdamState:
        leaf = tree_leaves(params)[0]

        def zeros(p):
            return torch.zeros(p.shape, dtype=self._mdtype(p), device=p.device)

        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=leaf.device),
            m=tree_map(zeros, params),
            v=tree_map(zeros, params),
        )

    @torch.no_grad()
    def update(self, grads, state: AdamState, params,
               gnorm: Optional[torch.Tensor] = None) -> Tuple[Any, AdamState, torch.Tensor]:
        """``(updates, AdamState, gnorm)``: the updates in the parameters'
        dtypes, the new moments, and the global norm of ``grads`` before
        clipping (f32).  A caller whose ``grads`` are one rank's blocks of
        the global gradients passes the global norm as ``gnorm``."""
        step = state.step + 1
        if gnorm is None:
            gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        lr = self.learning_rate(step)
        b1, b2 = self.b1, self.b2
        sf = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, sf)
        bc2 = 1.0 - torch.pow(b2, sf)

        def upd(g, m, v, p):
            g = g.to(torch.float32) * scale
            m32, v32 = m.to(torch.float32), v.to(torch.float32)
            m_new = b1 * m32 + (1 - b1) * g
            v_new = b2 * v32 + (1 - b2) * g * g
            mhat, vhat = m_new / bc1, v_new / bc2
            delta = mhat / (torch.sqrt(vhat) + self.eps) + self.weight_decay * p.to(torch.float32)
            return (-lr * delta).to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

        recs = [upd(*leaves) for leaves in zip(tree_leaves(grads), tree_leaves(state.m),
                                                tree_leaves(state.v), tree_leaves(params))]

        def field(i):
            return tree_unflatten(grads, [r[i] for r in recs])

        return field(0), AdamState(step=step, m=field(1), v=field(2)), gnorm


@torch.no_grad()
def apply_updates(params, updates):
    """Add ``updates`` to ``params`` in place (the JAX step donates its
    state; here the parameter tensors stay the same objects) and return
    ``params``."""
    tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
    return params


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    total = sum(torch.sum(leaf.to(torch.float32) ** 2) for leaf in leaves)
    return torch.sqrt(total)


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = peak * s / max(warmup, 1)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup, warm, cos)

    return lr


def constant_schedule(value: float):
    return lambda step: torch.full((), value, dtype=torch.float32, device=step.device)
