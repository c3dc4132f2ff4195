"""Plain PyTorch version of the diff-norm partials kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def diff_norm_partials_ref(a: torch.Tensor, b: torch.Tensor, block: int = 65536,
                           linf: bool = True) -> torch.Tensor:
    """Per-``block`` f32 partials of ``max|a−b|`` or ``Σ(a−b)²`` over the
    flattened inputs.  The difference is taken in the wider of (input type,
    f32) and then cast, so small f64 update differences do not quantise to
    zero before they are reduced."""
    ct = torch.promote_types(a.dtype, torch.float32)
    df = (a.reshape(-1).to(ct) - b.reshape(-1).to(ct)).to(torch.float32)
    n = df.numel()
    block = min(block, n)
    pad = (-n) % block
    if pad:
        df = F.pad(df, (0, pad))
    d = df.reshape(-1, block)
    if linf:
        return d.abs().amax(dim=1)
    return (d * d).sum(dim=1)
