"""GQA attention with the TP slot layout, blocked (flash-style) softmax,
sliding windows and KV-cache decode (port of ``models/attention.py``).

The slot layout is the JAX package's: kv groups padded to ``G2`` and
replicated ``kv_repl`` times, q heads padded per group and laid out as
``[slots, q_per_slot]``, padded q heads neutralised by zero rows of
``wo``.  At ``tp = 1`` the layout is the plain GQA one.  On a mesh of
``model`` width tp each rank holds ``slots / tp`` slots: q, k and v are
column-parallel (the rank projects its own slots, a replicated kv slot
included), attention runs on the rank's heads alone (the prefill's flash
kernel at per-rank shapes), and ``wo`` is row-parallel, its partial
output summed over ``model`` (``layers.row_parallel``, or the bf16
``tp_reduce``).  The decode cache holds the rank's slots.  Under dense
FSDP the projections are all-gathered over ``data`` just before use
(``layers.whole``).

``attention_fwd`` is the plain blocked online-softmax over KV blocks and
the plain version of the flash kernel on the model layout
(``kernels/flash_attention/ops.py`` sends CPU tensors here); training runs
it under autograd on the card too, as the JAX model does (the flash
kernel has no backward).  ``attention_fwd_pairs`` (``attn_impl="pairs"``)
is the same softmax over only the (q-block, kv-block) pairs inside the
causal/window band, also plain PyTorch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.models.collectives import copy_to
from repro_torch.models.layers import apply_rope, ceil_to, fill_, normal, row_parallel, \
    whole

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# TP head planning
# ---------------------------------------------------------------------------


def _smallest_divisor_geq(n: int, g: int) -> int:
    for d in range(g, n + 1):
        if n % d == 0:
            return d
    return n


@dataclass(frozen=True)
class AttentionPlan:
    num_heads: int       # original H
    num_kv_heads: int    # original G
    head_dim: int
    tp: int
    groups: int          # G2 (padded kv groups)
    q_per_group: int     # qpg2 (padded q heads per group)
    kv_repl: int         # copies of each kv group

    @property
    def slots(self) -> int:
        return self.groups * self.kv_repl

    @property
    def q_per_slot(self) -> int:
        return self.q_per_group // self.kv_repl

    @property
    def q_heads_padded(self) -> int:
        return self.groups * self.q_per_group

    def orig_qpg(self) -> int:
        return self.num_heads // self.num_kv_heads

    def q_slot_pos(self, h: int) -> Tuple[int, int]:
        """(slot, pos) of original q head h."""
        g, q = divmod(h, self.orig_qpg())
        return g * self.kv_repl + q // self.q_per_slot, q % self.q_per_slot

    def kv_slot_group(self, s: int) -> int:
        """Original kv group whose copy lives in slot s (or -1 if padded)."""
        g = s // self.kv_repl
        return g if g < self.num_kv_heads else -1


def plan_attention(num_heads: int, num_kv_heads: int, head_dim: int, tp: int) -> AttentionPlan:
    if num_heads % num_kv_heads:
        raise ValueError("num_heads must be a multiple of num_kv_heads")
    g, qpg = num_kv_heads, num_heads // num_kv_heads
    if g >= tp:
        g2, repl = ceil_to(g, tp), 1
        qpg2 = qpg
    else:
        g2 = _smallest_divisor_geq(tp, g)
        repl = tp // g2
        qpg2 = ceil_to(qpg, repl)
    return AttentionPlan(
        num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
        tp=tp, groups=g2, q_per_group=qpg2, kv_repl=repl,
    )


def q_valid_mask(plan: AttentionPlan, device=None) -> torch.Tensor:
    """[slots, q_per_slot] f32 — 1 where an original q head lives."""
    m = torch.zeros((plan.slots, plan.q_per_slot), dtype=torch.float32)
    for h in range(plan.num_heads):
        s, p = plan.q_slot_pos(h)
        m[s, p] = 1.0
    return m.to(device)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """Slot-layout weights: ``wq`` [D, S, P, H], ``wk``/``wv`` [D, S, H],
    ``wo`` [S, P, H, D] and, with ``qkv_bias``, ``bq`` [S, P, H] and
    ``bk``/``bv`` [S, H]."""

    def __init__(self, d_model: int, plan: AttentionPlan, qkv_bias: bool,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.plan, self.d_model = plan, d_model
        S, P, H = plan.slots, plan.q_per_slot, plan.head_dim

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.wq, self.wk, self.wv = param(d_model, S, P, H), param(d_model, S, H), \
            param(d_model, S, H)
        self.wo = param(S, P, H, d_model)
        self.bq = param(S, P, H) if qkv_bias else None
        self.bk = param(S, H) if qkv_bias else None
        self.bv = param(S, H) if qkv_bias else None

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "Attention":
        """The JAX ``attn_init``: N(0, 1/D) projections with kv replicas
        tiled from one draw per group, N(0, 1/(heads·H)) ``wo`` with the
        rows of padded q heads zeroed, zero biases."""
        plan = self.plan
        D, S, P, H = self.d_model, plan.slots, plan.q_per_slot, plan.head_dim
        s_in = 1.0 / math.sqrt(D)
        s_out = 1.0 / math.sqrt(plan.num_heads * H)
        dt = self.wq.dtype
        fill_(self.wq, normal((D, S, P, H), s_in, gen, torch.float32).to(dt))
        for w in (self.wk, self.wv):
            base = normal((D, plan.groups, H), s_in, gen, torch.float32)
            fill_(w, torch.repeat_interleave(base, plan.kv_repl, dim=1).to(dt))
        wo = normal((S, P, H, D), s_out, gen, torch.float32)
        wo = wo * q_valid_mask(plan, wo.device)[..., None, None]
        fill_(self.wo, wo.to(dt))
        for b in (self.bq, self.bk, self.bv):
            if b is not None:
                b.zero_()
        return self


# ---------------------------------------------------------------------------
# Blocked online-softmax attention (flash-style, plain)
# ---------------------------------------------------------------------------


def attention_fwd(
    q: torch.Tensor,              # [B, Sq, N, P, H]
    k: torch.Tensor,              # [B, Skv, N, H]
    v: torch.Tensor,              # [B, Skv, N, H]
    causal: bool = True,
    window: int = 0,              # 0 = full; >0 = sliding window
    block_kv: int = 1024,
    q_offset: int = 0,            # position offset of q within the kv timeline
) -> torch.Tensor:
    """Online softmax over KV blocks; returns [B, Sq, N, P, H] (q dtype)."""
    B, Sq, N, P, H = q.shape
    Skv = k.shape[1]
    dev = q.device
    # q · scale in q's dtype, the scale rounded to it first — what JAX does
    # with a weakly typed Python float; made by a fill kernel (a tensor
    # copied from the host would wait for the card)
    qf = (q * torch.full((), 1.0 / math.sqrt(H), dtype=q.dtype, device=dev)).float()
    block_kv = min(block_kv, Skv)
    nblk = (Skv + block_kv - 1) // block_kv
    pad = nblk * block_kv - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    kb = k.reshape(B, nblk, block_kv, N, H).float()
    vb = v.reshape(B, nblk, block_kv, N, H).float()
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, N, P, Sq), NEG_INF, dtype=torch.float32, device=dev)
    lsum = torch.zeros((B, N, P, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, N, P, Sq, H), dtype=torch.float32, device=dev)
    for blk in range(nblk):
        kv_pos = blk * block_kv + torch.arange(block_kv, device=dev)
        s = torch.einsum("bqnph,bknh->bnpqk", qf, kb[:, blk])  # [B,N,P,Sq,block]
        if causal:
            mask = kv_pos[None, :] <= q_pos[:, None]
        else:
            mask = (kv_pos[None, :] <= Skv).expand(Sq, block_kv)
        if window:
            mask = mask & (kv_pos[None, :] > (q_pos[:, None] - window))
        mask = mask & (kv_pos < Skv)[None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new[..., None])
        lsum = lsum * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bnpqk,bknh->bnpqh", pexp, vb[:, blk])
        m = m_new
    out = acc / torch.clamp_min(lsum[..., None], 1e-30)
    return out.movedim(3, 1).to(q.dtype)  # [B,Sq,N,P,H]


def attention_fwd_pairs(
    q: torch.Tensor,              # [B, Sq, N, P, H]
    k: torch.Tensor,              # [B, Skv, N, H]
    v: torch.Tensor,              # [B, Skv, N, H]
    causal: bool = True,
    window: int = 0,
    block_q: int = 512,
    block_kv: int = 512,
) -> torch.Tensor:
    """Causal **block-skipping** online softmax: a loop over the static
    list of (q-block, kv-block) pairs inside the causal/window band, each
    updating its q-block's (m, l, acc).  ``attention_fwd`` streams every
    kv block for every q position; here the blocks wholly above the
    diagonal or outside the window are never computed.  Differentiable:
    each q-block's accumulators are tensors of their own, replaced at each
    of its pairs (JAX updates slices of one carry in place)."""
    B, Sq, N, P, H = q.shape
    Skv = k.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(H)
    block_q = min(block_q, Sq)
    block_kv = min(block_kv, Skv)
    if Sq % block_q or Skv % block_kv:
        raise ValueError(f"block_q {block_q} / block_kv {block_kv} must divide "
                         f"Sq {Sq} / Skv {Skv}")
    nq, nk = Sq // block_q, Skv // block_kv

    pairs = []
    for i in range(nq):
        q_lo = i * block_q
        q_hi = q_lo + block_q - 1
        for j in range(nk):
            kv_lo, kv_hi = j * block_kv, (j + 1) * block_kv - 1
            if causal and kv_lo > q_hi:
                continue  # entirely above the diagonal
            if window > 0 and kv_hi <= q_lo - window:
                continue  # entirely outside the window band
            pairs.append((i, j))

    qf = q.movedim(1, 3).float() * scale          # [B,N,P,Sq,H]
    kf = k.movedim(1, 2).float()                  # [B,N,Skv,H]
    vf = v.movedim(1, 2).float()
    m = [torch.full((B, N, P, block_q), NEG_INF, dtype=torch.float32, device=dev)
         for _ in range(nq)]
    lsum = [torch.zeros((B, N, P, block_q), dtype=torch.float32, device=dev)
            for _ in range(nq)]
    acc = [torch.zeros((B, N, P, block_q, H), dtype=torch.float32, device=dev)
           for _ in range(nq)]
    for i, j in pairs:
        qb = qf[:, :, :, i * block_q:(i + 1) * block_q]
        kb = kf[:, :, j * block_kv:(j + 1) * block_kv]
        vb = vf[:, :, j * block_kv:(j + 1) * block_kv]
        s = torch.einsum("bnpqh,bnkh->bnpqk", qb, kb)
        q_pos = i * block_q + torch.arange(block_q, device=dev)
        kv_pos = j * block_kv + torch.arange(block_kv, device=dev)
        mask = torch.ones((block_q, block_kv), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        if window > 0:
            mask = mask & (kv_pos[None, :] > (q_pos[:, None] - window))
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m[i], s.amax(dim=-1))
        alpha = torch.exp(m[i] - m_new)
        pexp = torch.exp(s - m_new[..., None])
        lsum[i] = lsum[i] * alpha + pexp.sum(dim=-1)
        acc[i] = acc[i] * alpha[..., None] + torch.einsum("bnpqk,bnkh->bnpqh", pexp, vb)
        m[i] = m_new
    out = torch.cat(acc, dim=3) / torch.clamp_min(torch.cat(lsum, dim=3)[..., None], 1e-30)
    return out.movedim(3, 1).to(q.dtype)


def mha_reference(q, k, v, causal=True, window=0, q_offset=0):
    """Naive reference (small shapes only)."""
    B, Sq, N, P, H = q.shape
    Skv = k.shape[1]
    dev = q.device
    s = torch.einsum("bqnph,bknh->bnpqk", q.float(), k.float()) / math.sqrt(H)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    kv_pos = torch.arange(Skv, device=dev)
    if causal:
        mask = kv_pos[None, :] <= q_pos[:, None]
    else:
        mask = (kv_pos[None, :] <= Skv).expand(Sq, Skv)
    if window:
        mask = mask & (kv_pos[None, :] > (q_pos[:, None] - window))
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnpqk,bknh->bnpqh", p, v.float())
    return out.movedim(3, 1).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode (KV cache) attention
# ---------------------------------------------------------------------------


def decode_attention(
    q: torch.Tensor,                        # [B, 1, N, P, H]
    k_cache: torch.Tensor,                  # [B, Scache, N, H]
    v_cache: torch.Tensor,                  # [B, Scache, N, H]
    cache_len: Union[int, torch.Tensor],    # [] or [B] — valid cache entries
    window: int = 0,
    ring: bool = False,                     # ring buffer (valid entries wrap)
) -> torch.Tensor:
    B, _, N, P, H = q.shape
    S = k_cache.shape[1]
    dev = q.device
    s = torch.einsum("bqnph,bknh->bnpqk", q.float(), k_cache.float()) / math.sqrt(H)
    pos = torch.arange(S, device=dev)
    cl = torch.as_tensor(cache_len, device=dev)
    cl = cl[:, None] if cl.dim() else cl.reshape(1, 1)
    if ring:
        valid = pos[None, :] < torch.clamp_max(cl, S)   # whole ring valid once full
    else:
        valid = pos[None, :] < cl
        if window:
            valid = valid & (pos[None, :] >= (cl - window))
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnpqk,bknh->bnpqh", p, v_cache.float())
    return out.movedim(3, 1).to(q.dtype)


# ---------------------------------------------------------------------------
# Full attention block (projection + rope + core + output)
# ---------------------------------------------------------------------------


def attn_apply(
    p: Attention,
    x: torch.Tensor,               # [B, S, D]
    plan: AttentionPlan,
    rope_theta: float,
    positions: torch.Tensor,       # [S] absolute positions
    causal: bool = True,
    window: int = 0,
    block_kv: int = 1024,
    use_kernel: bool = False,
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # decode: (k, v) caches
    cache_len: Optional[int] = None,
    ring: bool = False,
    impl: str = "blocked",   # "blocked" | "pairs" (causal block skipping)
    mesh=None,               # a ModelMesh: p holds this rank's slots
    tp_reduce=None,          # explicit bf16 TP reduction for the o-proj
):
    """Returns (out [B,S,D], new_kv) where new_kv = (k, v) of this call.

    With a cache (decode) the new token's k/v are written into the caches
    in place, at ``min(cache_len, S_max − 1)`` (``cache_len % S_max`` for a
    ring), and attention runs over ``cache_len + 1`` valid entries; the
    caches themselves are returned.  On a mesh the projections and the
    cache are this rank's slots and the o-projection's partial output is
    summed over ``model``; the JAX ``constrain`` hook (a sharding
    constraint) has no counterpart, the layout being the parameters'.
    """
    x = copy_to(x, mesh, "model")
    q = torch.einsum("bsd,dnph->bsnph", x, whole(p.wq, mesh))
    k = torch.einsum("bsd,dnh->bsnh", x, whole(p.wk, mesh))
    v = torch.einsum("bsd,dnh->bsnh", x, whole(p.wv, mesh))
    wo = whole(p.wo, mesh)
    if p.bq is not None:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    # rope over the sequence axis (axis 1): move it next to last
    q = apply_rope(q.movedim(1, -2), positions, rope_theta).movedim(-2, 1)
    k = apply_rope(k.movedim(1, -2), positions, rope_theta).movedim(-2, 1)

    if cache is not None:
        # write the new token's k/v first (causal: a token attends to itself)
        k_cache, v_cache = cache
        S_max, S = k_cache.shape[1], k.shape[1]
        pos = (cache_len % S_max) if ring else min(cache_len, S_max - 1)
        k_cache[:, pos:pos + S] = k.to(k_cache.dtype)
        v_cache[:, pos:pos + S] = v.to(v_cache.dtype)
        out = decode_attention(q, k_cache, v_cache, cache_len + 1, window=window, ring=ring)
        return row_parallel("bsnph,nphd->bsd", out, wo, mesh), (k_cache, v_cache)
    if use_kernel:
        from repro_torch.kernels.flash_attention import ops as flash_ops

        out = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    elif impl == "pairs":
        out = attention_fwd_pairs(q, k, v, causal=causal, window=window)
    else:
        out = attention_fwd(q, k, v, causal=causal, window=window, block_kv=block_kv)
    if tp_reduce is not None:
        B_, S_ = out.shape[:2]
        y = tp_reduce(out.reshape(B_, S_, -1), wo.reshape(-1, wo.shape[-1]))
    else:
        y = row_parallel("bsnph,nphd->bsd", out, wo, mesh)
    return y, (k, v)
