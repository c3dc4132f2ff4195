"""Plain PyTorch version of the flash attention kernel on its flat layout
(naive, O(S²) memory) — the port of ``kernels/flash_attention/ref.py``."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [BH, Sq, H], k/v [BN, Skv, H] → [BH, Sq, H] in q's dtype; q-row
    ``bh`` reads kv-row ``bh // (BH // BN)``."""
    BH, Sq, H = q.shape
    BN, Skv, _ = k.shape
    rep = BH // BN
    # each kv row repeated ``rep`` times in place (jnp.repeat), by a
    # broadcast that needs no host sync, so a CUDA graph can capture it
    kf = k.float()[:, None].expand(BN, rep, Skv, H).reshape(BH, Skv, H)
    vf = v.float()[:, None].expand(BN, rep, Skv, H).reshape(BH, Skv, H)
    s = torch.einsum("bqh,bkh->bqk", q.float(), kf) / math.sqrt(H)
    q_pos = torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= kv_pos[None, :] > (q_pos[:, None] - window)
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, vf).to(q.dtype)
