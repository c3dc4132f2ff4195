"""Mamba2 blocks (SSD, state-space duality): port of ``models/ssm.py``.

Train and prefill use the chunked SSD algorithm: quadratic, attention-like
products inside chunks of Q positions and a short sequential recurrence
over the chunk states, O(S·Q) memory instead of O(S²).  Decode is the O(1)
state update.  SSD heads are padded to a multiple of the TP width, and the
padded heads are neutralised by zero (grad-masked) ``out_proj`` rows.  The
weights are stored stream by stream (``w_z``, ``w_x``, ``w_B``, ``w_C``,
``w_dt``), with the JAX leaf names.

On a mesh of ``model`` width tp (JAX's specs, ``Model.param_specs``) a rank
holds its ``heads_padded / tp`` heads of ``w_z``, ``w_x``, ``w_dt``,
``conv_x``, ``A_log``, ``D_skip``, ``dt_bias`` and ``norm``, and
``out_proj``'s rows of them (row-parallel, its partial output summed over
``model`` in f32); ``w_B``, ``w_C``, ``conv_B`` and ``conv_C`` are
replicated (one group in every config), each rank's heads giving them a
part of their gradient, which is summed over ``model``.  The SSD, the
convolutions and the decode step run on the local heads; the gated norm's
mean square is taken over the whole ``d_inner`` (padded heads included,
as in JAX): Σy² is all-reduced over ``model`` in f32.  The decode cache
holds the rank's heads of ``h`` and ``conv_x`` (JAX's ``cache_specs``).

One departure from the JAX ``ssd_chunked``: the intra-chunk decay masks
its exponent before ``exp``, ``exp(where(s ≤ t, cum_t − cum_s, −inf))``.
JAX takes ``exp(cum_t − cum_s)`` for every (t, s) and masks s > t after;
the masked exponents reach ≈ 100 at chunk 128 and random init, ``exp``
overflows to inf in f32, and the backward pass multiplies the zero
cotangent by inf, giving NaN gradients.  The forward value is JAX's, and
the gradients stay finite at any chunk.  The recurrence over chunks (JAX's
``lax.scan``) is a Python loop over ``S / chunk`` chunks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.collectives import copy_to, reduce_from
from repro_torch.models.layers import ceil_to, fill_, normal, rmsnorm, row_parallel, \
    tp_width, whole


@dataclass(frozen=True)
class SSMPlan:
    d_model: int
    heads: int            # original nh
    heads_padded: int
    head_dim: int         # P
    state: int            # N
    groups: int
    conv_width: int
    tp: int

    @property
    def d_inner(self) -> int:
        return self.heads_padded * self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.groups * self.state


def plan_ssm(cfg, tp: int) -> SSMPlan:
    nh = cfg.resolved_ssm_heads
    return SSMPlan(
        d_model=cfg.d_model,
        heads=nh,
        heads_padded=ceil_to(nh, tp),
        head_dim=cfg.ssm_head_dim,
        state=cfg.ssm_state,
        groups=cfg.ssm_groups,
        conv_width=cfg.ssm_conv_width,
        tp=tp,
    )


def head_valid_mask(plan: SSMPlan, device=None) -> torch.Tensor:
    """[heads_padded] f32 — 1 for an original SSD head, 0 for padding."""
    m = torch.zeros((plan.heads_padded,), dtype=torch.float32)
    m[: plan.heads] = 1.0
    return m.to(device)


class SSM(nn.Module):
    """The JAX ``ssm_init`` dict as parameters: ``w_z``/``w_x`` [D, di],
    ``w_B``/``w_C`` [D, G·N], ``w_dt`` [D, nh], ``conv_x`` [W, di],
    ``conv_B``/``conv_C`` [W, G·N], ``A_log``/``D_skip``/``dt_bias`` [nh]
    (f32), ``norm`` [di] and ``out_proj`` [di, D]."""

    def __init__(self, plan: SSMPlan, dtype: torch.dtype, device=None):
        super().__init__()
        self.plan = plan
        D, di, nh, W = plan.d_model, plan.d_inner, plan.heads_padded, plan.conv_width
        gn = plan.groups * plan.state

        def param(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.w_z, self.w_x = param(D, di), param(D, di)
        self.w_B, self.w_C = param(D, gn), param(D, gn)
        self.w_dt = param(D, nh)
        self.conv_x, self.conv_B, self.conv_C = param(W, di), param(W, gn), param(W, gn)
        self.A_log = param(nh, dt=torch.float32)
        self.D_skip = param(nh, dt=torch.float32)
        self.dt_bias = param(nh, dt=torch.float32)
        self.norm = param(di)
        self.out_proj = param(di, D)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "SSM":
        """The JAX ``ssm_init``: N(0, 1/D) input projections, N(0, 0.2²)
        convolutions, A_log 0 (A = −1), D_skip 1, dt_bias 0, norm 1, and
        N(0, 1/di) ``out_proj`` with the rows of padded heads zeroed.  Each
        weight is drawn at its global shape; a rank of a mesh keeps its
        block (``layers.fill_``)."""
        plan = self.plan
        D, di, nh, W = plan.d_model, plan.d_inner, plan.heads_padded, plan.conv_width
        gn = plan.groups * plan.state
        s = 1.0 / math.sqrt(D)
        for w, shape in ((self.w_z, (D, di)), (self.w_x, (D, di)), (self.w_B, (D, gn)),
                         (self.w_C, (D, gn)), (self.w_dt, (D, nh))):
            fill_(w, normal(shape, s, gen, w.dtype))
        for w, shape in ((self.conv_x, (W, di)), (self.conv_B, (W, gn)), (self.conv_C, (W, gn))):
            fill_(w, normal(shape, 0.2, gen, w.dtype))
        self.A_log.zero_()
        self.D_skip.fill_(1.0)
        self.dt_bias.zero_()
        self.norm.fill_(1.0)
        out = normal((di, D), 1.0 / math.sqrt(di), gen, torch.float32)
        rows = head_valid_mask(plan, out.device).repeat_interleave(plan.head_dim)
        fill_(self.out_proj, (out * rows[:, None]).to(self.out_proj.dtype))
        return self


# ---------------------------------------------------------------------------
# Causal depthwise conv
# ---------------------------------------------------------------------------


def causal_conv(x: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None):
    """x [B, S, C], w [W, C] depthwise causal conv.  With ``state``
    [B, W−1, C] (decode or chunk continuation) it is prepended; returns
    (silu(y), new_state)."""
    W = w.shape[0]
    S = x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = 0
    for i in range(W):   # the JAX sum's order
        y = y + xp[:, i:i + S, :] * w[i][None, None, :]
    new_state = xp[:, -(W - 1):, :] if W > 1 else x.new_zeros((x.shape[0], 0, x.shape[2]))
    return F.silu(y), new_state


# ---------------------------------------------------------------------------
# Chunked SSD (train / prefill)
# ---------------------------------------------------------------------------


def ssd_chunked(
    x: torch.Tensor,      # [B, S, nh, P]
    dt: torch.Tensor,     # [B, S, nh]   (post-softplus)
    A: torch.Tensor,      # [nh]         (negative)
    Bm: torch.Tensor,     # [B, S, G, N]
    Cm: torch.Tensor,     # [B, S, G, N]
    chunk: int = 128,
    h0: Optional[torch.Tensor] = None,  # [B, nh, P, N] initial state
):
    """Returns (y [B, S, nh, P] in x's dtype, h_final [B, nh, P, N] f32)."""
    Bsz, S, nh, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence must be a multiple of the SSD chunk: S={S}, "
                         f"chunk={chunk}")
    nc = S // chunk
    rep = nh // G

    xf = x.float().reshape(Bsz, nc, chunk, nh, P)
    dtf = dt.float().reshape(Bsz, nc, chunk, nh)
    Bh = Bm.float().reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    Ch = Cm.float().reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, dim=3)

    dA = dtf * A[None, None, None, :]                    # [B,nc,Q,nh], ≤ 0
    cum = torch.cumsum(dA, dim=2)                        # within-chunk cumulative
    total = cum[:, :, -1, :]                             # [B,nc,nh]
    xb = xf * dtf[..., None]                             # dt-scaled input

    # --- intra-chunk (quadratic, masked) ---
    # scores[t, s] = (C_t·B_s) exp(cum_t − cum_s), s ≤ t; the exponent is
    # masked before exp (module docstring)
    cb = torch.einsum("bcthn,bcshn->bchts", Ch, Bh)      # [B,nc,nh,Q,Q]
    diff = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).movedim(-1, 2)  # [B,nc,nh,Qt,Qs]
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(mask, diff, float("-inf")))
    scores = cb * decay
    y_intra = torch.einsum("bchts,bcshp->bcthp", scores, xb)

    # --- chunk states ---
    dec_end = torch.exp(total[:, :, None, :] - cum)      # [B,nc,Q,nh]
    S_c = torch.einsum("bcshn,bcshp,bcsh->bchpn", Bh, xb, dec_end)  # [B,nc,nh,P,N]

    # --- inter-chunk recurrence ---
    h = torch.zeros((Bsz, nh, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0
    decay_c = torch.exp(total)
    h_prevs = []                                         # state entering each chunk
    for c in range(nc):
        h_prevs.append(h)
        h = decay_c[:, c, :, None, None] * h + S_c[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                 # [B,nc,nh,P,N]

    # --- inter-chunk contribution ---
    y_inter = torch.einsum("bcthn,bchpn,bcth->bcthp", Ch, h_prev, torch.exp(cum))
    y = (y_intra + y_inter).reshape(Bsz, S, nh, P)
    return y.to(x.dtype), h


def ssd_decode_step(
    x: torch.Tensor,     # [B, nh, P]
    dt: torch.Tensor,    # [B, nh]
    A: torch.Tensor,     # [nh]
    Bm: torch.Tensor,    # [B, G, N]
    Cm: torch.Tensor,    # [B, G, N]
    h: torch.Tensor,     # [B, nh, P, N]
):
    """One recurrence step; returns (y [B, nh, P] in x's dtype, h_new)."""
    nh, G = x.shape[1], Bm.shape[1]
    rep = nh // G
    Bh = Bm.repeat_interleave(rep, dim=1).float()
    Ch = Cm.repeat_interleave(rep, dim=1).float()
    dtf = dt.float()
    da = torch.exp(dtf * A[None, :])                     # [B,nh]
    upd = torch.einsum("bhn,bhp,bh->bhpn", Bh, x.float(), dtf)
    h_new = da[:, :, None, None] * h + upd
    y = torch.einsum("bhn,bhpn->bhp", Ch, h_new)
    return y.to(x.dtype), h_new


# ---------------------------------------------------------------------------
# Full mamba2 block
# ---------------------------------------------------------------------------


class SSMCache(NamedTuple):
    h: torch.Tensor          # [B, nh, P, N] f32
    conv_x: torch.Tensor     # [B, W−1, d_inner]
    conv_B: torch.Tensor     # [B, W−1, G·N]
    conv_C: torch.Tensor     # [B, W−1, G·N]


def ssm_cache_init(plan: SSMPlan, batch: int, dtype: torch.dtype, device=None,
                   tp: int = 1) -> SSMCache:
    """A zeroed cache; at ``tp`` > 1 of one rank's ``heads_padded / tp``
    heads (``h``, ``conv_x``)."""
    W = plan.conv_width
    gn = plan.groups * plan.state
    nh = plan.heads_padded // tp
    return SSMCache(
        h=torch.zeros((batch, nh, plan.head_dim, plan.state),
                      dtype=torch.float32, device=device),
        conv_x=torch.zeros((batch, W - 1, nh * plan.head_dim), dtype=dtype, device=device),
        conv_B=torch.zeros((batch, W - 1, gn), dtype=dtype, device=device),
        conv_C=torch.zeros((batch, W - 1, gn), dtype=dtype, device=device),
    )


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float,
                d_inner: int, mesh) -> torch.Tensor:
    """``rmsnorm(y · silu(z))`` over the whole ``d_inner``: at ``model``
    width > 1 ``y`` holds this rank's heads, so Σy² is summed over
    ``model`` in f32 and divided by the global width.  The sum enters every
    rank's heads, so its gradient is summed too (``reduce_from`` then
    ``copy_to``: an all-reduce each way)."""
    g = y * F.silu(z)
    if tp_width(mesh) == 1:
        return rmsnorm(g, scale, eps)
    g32 = g.float()
    ss = copy_to(reduce_from((g32 * g32).sum(dim=-1, keepdim=True), mesh, "model"),
                 mesh, "model")
    return (g32 * torch.rsqrt(ss / d_inner + eps) * scale.float()).to(g.dtype)


def ssm_apply(
    p: SSM,
    x: torch.Tensor,                    # [B, S, D]
    plan: SSMPlan,
    chunk: int = 128,
    cache: Optional[SSMCache] = None,   # decode (S == 1) or continuation
    norm_eps: float = 1e-5,
    mesh=None,                          # a ModelMesh: p holds this rank's heads
):
    """Returns (y [B, S, D], new_cache).  The JAX ``constrain`` hook has no
    counterpart: on a mesh the layout is the parameters' blocks."""
    B, S, D = x.shape
    P, N, G = plan.head_dim, plan.state, plan.groups
    nh = p.A_log.shape[0]                 # this rank's heads (all of them at tp 1)
    x = copy_to(x, mesh, "model")
    # the replicated B / C streams: each rank's heads give part of their
    # gradient, summed over ``model`` by ``copy_to``
    w_B = copy_to(whole(p.w_B, mesh), mesh, "model")
    w_C = copy_to(whole(p.w_C, mesh), mesh, "model")
    conv_B, conv_C = copy_to(p.conv_B, mesh, "model"), copy_to(p.conv_C, mesh, "model")
    z = torch.einsum("bsd,di->bsi", x, whole(p.w_z, mesh))
    xs = torch.einsum("bsd,di->bsi", x, whole(p.w_x, mesh))
    Bs = torch.einsum("bsd,dg->bsg", x, w_B)
    Cs = torch.einsum("bsd,dg->bsg", x, w_C)
    dt = torch.einsum("bsd,dh->bsh", x, whole(p.w_dt, mesh))
    dt = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)

    xs, ncx = causal_conv(xs, p.conv_x, cache.conv_x if cache is not None else None)
    Bs, ncB = causal_conv(Bs, conv_B, cache.conv_B if cache is not None else None)
    Cs, ncC = causal_conv(Cs, conv_C, cache.conv_C if cache is not None else None)

    xh = xs.reshape(B, S, nh, P)
    Bm = Bs.reshape(B, S, G, N)
    Cm = Cs.reshape(B, S, G, N)

    if S == 1 and cache is not None:
        y, h_new = ssd_decode_step(xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], cache.h)
        y = y[:, None]
    else:
        y, h_new = ssd_chunked(xh, dt, A, Bm, Cm, chunk=chunk,
                               h0=cache.h if cache is not None else None)

    y = y + p.D_skip[None, None, :, None].to(y.dtype) * xh
    y = _gated_norm(y.reshape(B, S, nh * P), z, p.norm, norm_eps, plan.d_inner, mesh)
    out = row_parallel("bsi,id->bsd", y, whole(p.out_proj, mesh), mesh)
    return out, SSMCache(h=h_new, conv_x=ncx, conv_B=ncB, conv_C=ncC)
