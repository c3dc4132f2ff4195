"""Distributed residual-error evaluation (paper §2.2).

A residual function ``r`` is distributed as ``r(x) = σ(r_1(x), …, r_p(x))``
where each ``r_i`` is local to one worker and ``σ`` is a reduction.  For the
l-norms of the paper,

    r(x) = ‖x − f(x)‖_l,   r_i = (‖·‖^(i))^l,   σ(α) = (Σ α_j)^(1/l),

and for the max-norm σ is the plain max.  The shard runtime stacks its
shards' contributions along one tensor dimension, so the collective of the
JAX package (``psum``/``pmax``) is a reduction over that dimension here.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

Ord = Union[int, float, str]


def _as_ord(ord: Ord) -> float:
    if ord in ("inf", "max", np.inf, float("inf")):
        return float("inf")
    return float(ord)


#: what a kernel's partials reduce (the C interface's ``int mode``): Σr²,
#: max|r| or Σ|r|
L2, LINF, L1 = 0, 1, 2


def partial_mode(ord: Ord) -> int:
    """The kernels' partial mode for the l-norm order ``ord``: Σr² for 2,
    max|r| for ∞, Σ|r| for 1.  The kernels have no other mode, so any other
    order raises (the JAX kernel ops treat every finite order as 2)."""
    lp = _as_ord(ord)
    if np.isinf(lp):
        return LINF
    if lp == 2.0:
        return L2
    if lp == 1.0:
        return L1
    raise ValueError(f"the kernels support ord 1, 2 or inf, got {ord}")


def local_contribution(diff: torch.Tensor, ord: Ord = 2) -> torch.Tensor:
    """``r_i``: the local, *pre-reduction* contribution of one worker (f32).

    For finite l this is ``Σ|d|^l`` (NOT the root — roots commute with the
    global reduction only if taken after σ); for l=∞ it is ``max|d|``.  The
    difference is cast to f32 *before* ``abs``, as in the JAX package.
    """
    lp = _as_ord(ord)
    a = diff.to(torch.float32).abs()
    if np.isinf(lp):
        return a.amax() if a.numel() else a.new_zeros(())
    if lp == 2.0:
        return (a * a).sum()
    return (a**lp).sum()


def sigma(contributions: torch.Tensor, ord: Ord = 2) -> torch.Tensor:
    """``σ``: reduce a vector of local contributions to the global residual."""
    return psum_sigma(contributions.reshape(-1), ord)


def psum_sigma(contributions: torch.Tensor, ord: Ord = 2, dim: int = 0) -> torch.Tensor:
    """σ over the shard dimension ``dim`` of stacked per-shard contributions
    — the stacked-transport form of the JAX package's ``psum``/``pmax``."""
    lp = _as_ord(ord)
    if np.isinf(lp):
        return contributions.amax(dim)
    s = contributions.sum(dim)
    if lp == 2.0:
        return torch.sqrt(s)
    return s ** (1.0 / lp)


def global_residual(x: torch.Tensor, fx: torch.Tensor, ord: Ord = 2) -> torch.Tensor:
    """Reference (non-distributed) residual ``‖x − f(x)‖_l``; the
    difference is cast to f32 before the norm, as in the JAX package."""
    lp = _as_ord(ord)
    d = (x - fx).to(torch.float32).abs()
    if np.isinf(lp):
        return d.amax()
    if lp == 2.0:
        return torch.sqrt((d * d).sum())
    return (d**lp).sum() ** (1.0 / lp)


def combine_contributions(parts: Sequence[float], ord: Ord = 2) -> float:
    """Host-side σ over plain numbers."""
    lp = _as_ord(ord)
    arr = np.asarray(parts, dtype=np.float64)
    if np.isinf(lp):
        return float(arr.max()) if arr.size else 0.0
    s = float(arr.sum())
    if lp == 2.0:
        return float(np.sqrt(s))
    return float(s ** (1.0 / lp))
