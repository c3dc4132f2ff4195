"""Common layers: norms, RoPE, MLPs, embeddings (port of ``models/layers.py``).

Plain functions on tensors with explicit dtypes, as in the JAX package:
RMSNorm and RoPE compute in f32 and cast back, the LM head is f32 on both
sides.  The initialisers draw from an explicit ``torch.Generator`` with the
JAX package's distributions and scales (``jax.random`` itself cannot be
reproduced, so the numbers differ).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def normal(shape: Tuple[int, ...], std: float, gen: torch.Generator,
           dtype: torch.dtype) -> torch.Tensor:
    """N(0, std²) drawn in f32 on the generator's device, then cast — the
    JAX initialisers' ``(normal(key, shape) * std).astype(dtype)``."""
    return (torch.randn(shape, generator=gen, device=gen.device) * std).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split halves, not interleaved)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)  # [hd/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, hd] (hd trailing); positions: integer, broadcastable
    to [..., seq]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs  # [..., seq, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """``w1`` [d, f], ``w2`` [f, d] and, gated, ``w3`` [d, f] — the JAX
    ``mlp_init`` dict as parameters."""

    def __init__(self, d: int, f: int, gated: bool, dtype: torch.dtype, device=None):
        super().__init__()
        self.w1 = nn.Parameter(torch.empty((d, f), dtype=dtype, device=device),
                               requires_grad=False)
        self.w2 = nn.Parameter(torch.empty((f, d), dtype=dtype, device=device),
                               requires_grad=False)
        self.w3 = (nn.Parameter(torch.empty((d, f), dtype=dtype, device=device),
                                requires_grad=False) if gated else None)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "MLP":
        """The JAX ``mlp_init``: N(0, 1/d) in, N(0, 1/f) out."""
        d, f = self.w1.shape
        s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
        self.w1.copy_(normal((d, f), s_in, gen, self.w1.dtype))
        self.w2.copy_(normal((f, d), s_out, gen, self.w2.dtype))
        if self.w3 is not None:
            self.w3.copy_(normal((d, f), s_in, gen, self.w3.dtype))
        return self


def mlp_apply(p: MLP, x: torch.Tensor, gated: bool) -> torch.Tensor:
    h = torch.einsum("...d,df->...f", x, p.w1)
    if gated:
        h = F.silu(h) * torch.einsum("...d,df->...f", x, p.w3)
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return torch.einsum("...f,fd->...d", h, p.w2)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embed_init(vocab: int, d: int, gen: torch.Generator, dtype: torch.dtype) -> torch.Tensor:
    return normal((vocab, d), 0.02, gen, dtype)


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return emb[tokens.long()]


def lm_head(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., d] × w [vocab, d] → logits [..., vocab] (f32)."""
    return torch.einsum("...d,vd->...v", x.float(), w.float())
