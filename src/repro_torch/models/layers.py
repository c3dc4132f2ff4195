"""Common layers: norms, RoPE, MLPs, embeddings (port of ``models/layers.py``).

Plain functions on tensors with explicit dtypes, as in the JAX package:
RMSNorm and RoPE compute in f32 and cast back, the LM head is f32 on both
sides.  The initialisers draw from an explicit ``torch.Generator`` with the
JAX package's distributions and scales (``jax.random`` itself cannot be
reproduced, so the numbers differ).

On a mesh (``mesh`` given, its ``model`` axis wider than 1) the MLP is
column- then row-parallel: ``w1`` / ``w3`` hold this rank's d_ff columns,
``w2`` its d_ff rows, and the partial down-projection is summed over
``model`` in f32, as GSPMD reduces a dot's partial sums (``tp_reduce``
sums bf16 partials instead).  The embedding is vocab-parallel: a rank
looks up the tokens in its rows (clamped, the rest masked to zero) and
the lookups are summed over ``model``, the lowering GSPMD picks for a
vocab-sharded table.  A parameter that holds a block of a global tensor
carries the block's slices as ``local``; ``fill_`` writes a global draw's
block into it.  Under dense FSDP a weight split over ``data`` also
carries ``fsdp_gather = (axis, dim)``, and ``whole`` all-gathers it just before
use (its gradient reduce-scattered back), as GSPMD does for a weight whose
spec names ``data``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.collectives import copy_to, gather_rs, reduce_from

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


def fill_(param: torch.Tensor, value: torch.Tensor) -> None:
    """Copy a global ``value`` into ``param``, or its block where the
    parameter holds one (``param.local``, the block's slices)."""
    block = getattr(param, "local", None)
    param.copy_(value[block] if block is not None else value)


def whole(w: torch.Tensor, mesh) -> torch.Tensor:
    """A weight as the layer uses it: under dense FSDP (``w.fsdp_gather``, set
    by ``Model`` on a weight split over ``data``) its blocks all-gathered
    over that axis, the gradient reduce-scattered back
    (``collectives.gather_rs``); else the weight itself.  Inside a remat
    region the recompute gathers again."""
    g = getattr(w, "fsdp_gather", None)
    return w if g is None else gather_rs(w, mesh, g[0], g[1])


def tp_width(mesh) -> int:
    """The mesh's ``model`` width (1 without a mesh)."""
    return 1 if mesh is None else mesh.size("model")


def row_parallel(eq: str, h: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """``einsum(eq, h, w)`` over this rank's block of the contracted width,
    summed over ``model`` in f32 (the dot's accumulation type, as GSPMD
    reduces it) and cast to the operands' type; the plain einsum without a
    mesh or at width 1."""
    if tp_width(mesh) == 1:
        return torch.einsum(eq, h, w)
    out_dtype = torch.promote_types(h.dtype, w.dtype)
    return reduce_from(torch.einsum(eq, h.float(), w.float()), mesh, "model").to(out_dtype)


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
        self.d, self.f = d, f
        self.w1 = nn.Parameter(torch.empty((d, f), dtype=dtype, device=device),
                               requires_grad=False)
        self.w2 = nn.Parameter(torch.empty((f, d), dtype=dtype, device=device),
                               requires_grad=False)
        self.w3 = (nn.Parameter(torch.empty((d, f), dtype=dtype, device=device),
                                requires_grad=False) if gated else None)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "MLP":
        """The JAX ``mlp_init``: N(0, 1/d) in, N(0, 1/f) out."""
        d, f = self.d, self.f
        s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
        fill_(self.w1, normal((d, f), s_in, gen, self.w1.dtype))
        fill_(self.w2, normal((f, d), s_out, gen, self.w2.dtype))
        if self.w3 is not None:
            fill_(self.w3, normal((d, f), s_in, gen, self.w3.dtype))
        return self


def mlp_apply(p: MLP, x: torch.Tensor, gated: bool, mesh=None, tp_reduce=None) -> torch.Tensor:
    x = copy_to(x, mesh, "model")
    h = torch.einsum("...d,df->...f", x, whole(p.w1, mesh))
    if gated:
        h = F.silu(h) * torch.einsum("...d,df->...f", x, whole(p.w3, mesh))
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    w2 = whole(p.w2, mesh)
    if tp_reduce is not None:
        return tp_reduce(h, w2)
    return row_parallel("...f,fd->...d", h, w2, mesh)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def embed_init(vocab: int, d: int, gen: torch.Generator, dtype: torch.dtype) -> torch.Tensor:
    return normal((vocab, d), 0.02, gen, dtype)


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """The rows of ``tokens``; on a mesh ``emb`` is this rank's block of
    the vocabulary, and the masked lookups are summed over ``model``."""
    if tp_width(mesh) == 1:
        return emb[tokens.long()]
    n = emb.shape[0]
    ids = tokens.long() - mesh.index("model") * n
    inside = (ids >= 0) & (ids < n)
    x = torch.where(inside[..., None], emb[ids.clamp(0, n - 1)], 0.0)
    return reduce_from(x.to(emb.dtype), mesh, "model")


def lm_head(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., d] × w [vocab, d] → logits [..., vocab] (f32)."""
    return torch.einsum("...d,vd->...v", x.float(), w.float())
