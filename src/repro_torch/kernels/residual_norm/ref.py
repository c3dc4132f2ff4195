"""Plain PyTorch version of the diff-norm partials kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.residual import L1, LINF, partial_mode


def diff_norm_partials_ref(a: torch.Tensor, b: torch.Tensor, block: int = 65536,
                           ord: float = float("inf")) -> torch.Tensor:
    """Per-``block`` f32 partials of ``max|a−b|`` (ord ∞), ``Σ(a−b)²``
    (2) or ``Σ|a−b|`` (1) over the flattened inputs.  The difference is
    taken in the wider of (input type, f32) and then cast, so small f64
    update differences do not quantise to zero before they are reduced."""
    mode = partial_mode(ord)
    ct = torch.promote_types(a.dtype, torch.float32)
    df = (a.reshape(-1).to(ct) - b.reshape(-1).to(ct)).to(torch.float32)
    n = df.numel()
    block = min(block, n)
    pad = (-n) % block
    if pad:
        df = F.pad(df, (0, pad))
    d = df.reshape(-1, block)
    if mode == LINF:
        return d.abs().amax(dim=1)
    if mode == L1:
        return d.abs().sum(dim=1)
    return (d * d).sum(dim=1)
