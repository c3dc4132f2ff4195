"""Fused ‖a−b‖_l and the shard runtime's update-difference contribution."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import residual as res
from repro_torch.kernels import _build
from repro_torch.kernels.residual_norm.residual_norm import diff_norm_partials


def diff_norm(a: torch.Tensor, b: torch.Tensor,
              ord: float = float("inf")) -> torch.Tensor:
    """‖a − b‖_ord for ord ∈ {2, ∞}, computed blockwise."""
    linf = np.isinf(ord)
    if not linf and float(ord) != 2.0:
        raise ValueError(f"diff_norm supports ord 2 or inf, got {ord}")
    parts = diff_norm_partials(a, b, linf=linf)
    return parts.amax() if linf else torch.sqrt(parts.sum())


def update_contribution(new: torch.Tensor, old: torch.Tensor,
                        ord: float = 2.0, scale: float = 1.0) -> torch.Tensor:
    """Pre-σ local contribution of ``r = scale · (new − old)`` (f32).

    For relaxations whose residual is the update difference (Jacobi:
    ``r = diag·(x⁺ − x)``), the contribution is a fused diff-norm of the two
    states with the constant factor hoisted out of the reduction:
    ``f32(s²) · Σ|Δ|²`` for l2, ``s · max|Δ|`` for l∞ (s = |scale|).  Other
    l have no kernel: CPU tensors take ``core.residual``, CUDA ones raise.
    """
    s = abs(float(scale))
    if np.isinf(ord):
        return s * diff_norm_partials(new, old, linf=True).amax()
    if float(ord) == 2.0:
        return float(np.float32(s * s)) * diff_norm_partials(new, old, linf=False).sum()
    if _build.on_cuda(new, old):
        raise ValueError(f"the diff-norm kernel supports ord 2 or inf, got {ord}")
    return res.local_contribution(scale * (new - old), ord)
