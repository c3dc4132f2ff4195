"""Plain PyTorch version of the flash attention kernel on its flat layout
(naive, O(S²) memory) — the port of ``kernels/flash_attention/ref.py`` —
and the element-wise bar that holds the bf16 kernel to it."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q [BH, Sq, H], k/v [BN, Skv, H] → [BH, Sq, H] in q's dtype; q-row
    ``bh`` reads kv-row ``bh // (BH // BN)``.  Computes in the wider of
    (input type, f32)."""
    BH, Sq, H = q.shape
    BN, Skv, _ = k.shape
    rep = BH // BN
    ct = torch.promote_types(q.dtype, torch.float32)
    # each kv row repeated ``rep`` times in place (jnp.repeat), by a
    # broadcast that needs no host sync, so a CUDA graph can capture it
    kf = k.to(ct)[:, None].expand(BN, rep, Skv, H).reshape(BH, Skv, H)
    vf = v.to(ct)[:, None].expand(BN, rep, Skv, H).reshape(BH, Skv, H)
    s = torch.einsum("bqh,bkh->bqk", q.to(ct), kf) / math.sqrt(H)
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


def bf16_output_bar(want: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Element-wise bound (f64) on |kernel − want| for a bf16 kernel output,
    ``want = flash_attention_ref(q, k, v)`` in bf16.

    The kernel keeps f32 (m, l, acc) and rounds each p to bf16 for the P·V
    product, with l summed from the f32 p.  With unit roundoff u = 2^-8,
    bf16(p_j) = p_j(1 + δ_j), |δ_j| ≤ u, so its f32 output before the last
    rounding is Σ p_j v_j / l + Σ p_j δ_j v_j / l: the plain version's f32
    value plus at most u · Σ p_j |v_j| / l, which is the plain version
    applied to |v|.  Both sides then round to bf16: one step, at most
    2^-7·|want|, with 2^-7·rms(want) for f32 summation order near zero.
    So |Δ| ≤ 2^-7·(|want| + rms(want)) + 2^-8·flash_attention_ref(q, k, |v|),
    the last term computed in f64 from the same inputs."""
    w = want.double()
    rms = w.square().mean().sqrt()
    spread = flash_attention_ref(q.double(), k.double(), v.double().abs(),
                                 causal=causal, window=window)
    return 2.0 ** -7 * (w.abs() + rms) + 2.0 ** -8 * spread
