"""Fused ‖a−b‖_l and the runtimes' update-difference contributions."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import residual as res
from repro_torch.kernels import _build
from repro_torch.kernels.residual_norm.residual_norm import diff_norm_partials


def diff_norm(a: torch.Tensor, b: torch.Tensor,
              ord: float = float("inf")) -> torch.Tensor:
    """‖a − b‖_ord for ord ∈ {1, 2, ∞}, computed blockwise."""
    parts = diff_norm_partials(a, b, ord=ord)
    if np.isinf(ord):
        return parts.amax()
    return torch.sqrt(parts.sum()) if float(ord) == 2.0 else parts.sum()


def update_contribution(new: torch.Tensor, old: torch.Tensor,
                        ord: float = 2.0, scale: float = 1.0) -> torch.Tensor:
    """Pre-σ local contribution of ``r = scale · (new − old)`` (f32).

    For relaxations whose residual is the update difference (Jacobi:
    ``r = diag·(x⁺ − x)``), the contribution is a fused diff-norm of the two
    states with the constant factor hoisted out of the reduction:
    ``f32(s²) · Σ|Δ|²`` for l2, ``s · Σ|Δ|`` for l1, ``s · max|Δ|`` for l∞
    (s = |scale|).  Other l have no kernel: CPU tensors take
    ``core.residual``, CUDA ones raise.
    """
    s = abs(float(scale))
    if np.isinf(ord):
        return s * diff_norm_partials(new, old, ord=ord).amax()
    if float(ord) == 2.0:
        return float(np.float32(s * s)) * diff_norm_partials(new, old, ord=ord).sum()
    if float(ord) == 1.0:
        return s * diff_norm_partials(new, old, ord=ord).sum()
    if _build.on_cuda(new, old):
        res.partial_mode(ord)  # raises: the kernel has no such mode
    return res.local_contribution(scale * (new - old), ord)


def row_contributions(new: torch.Tensor, old: torch.Tensor,
                      ord: float = 2.0) -> torch.Tensor:
    """Pre-σ contribution of each row of ``new − old`` (f32): ``[r, n]``
    gives ``[r]``, a vector ``[n]`` one value of shape ``()``.  One launch
    of the diff-norm kernel with ``block = n``, so one partial per row: max|Δ|
    for l∞, Σ|Δ|² for l2, Σ|Δ| for l1.  Other l have no kernel: CPU tensors
    take ``core.residual``, CUDA ones raise."""
    if np.isinf(ord) or float(ord) in (1.0, 2.0):
        parts = diff_norm_partials(new, old, block=new.shape[-1], ord=ord)
        return parts.reshape(new.shape[:-1])
    if _build.on_cuda(new, old):
        res.partial_mode(ord)  # raises: the kernel has no such mode
    d = (new - old).to(torch.float32).abs()
    return (d ** float(ord)).sum(-1)
