"""Decoder backbone (port of ``models/transformer.py``): every block family.

The JAX package scans over units of ``moe_layer_period`` layers with
``[steps, …]`` stacked parameters; here the parameters are one
``nn.Module`` per layer and the forward pass is a Python loop over units
of ``period`` layers.  Block families:

    dense/audio/vlm : [norm → attn → +res] [norm → mlp → +res]
    moe             : same, MLP replaced by MoE (+ optional shared expert)
    ssm             : [norm → mamba2 → +res]
    hybrid (hymba)  : [norm → attn ∥ mamba2 → mean → +res] [norm → mlp → +res]

With a modality frontend the inputs are embeddings [B, S, F] that enter
through ``frontend_proj`` [F, D], and the model always has an ``lm_head``.
In train mode each unit runs under the remat policy of ``LayerCtx.remat``
(``torch.utils.checkpoint`` where JAX wraps the scan body in
``jax.checkpoint``).  Parameters are made with ``requires_grad=False``,
for serving; ``Model.init_train_state`` switches it on.  Without a mesh
the MoE layer is ``moe_local_reference``, JAX's dense one-hot path; with
one (``LayerCtx.mesh``) it is the expert-parallel ``moe.moe_apply``, and
the attention, MLPs, embedding and head run on this rank's blocks
(``Transformer(plan, device, blocks)``: each parameter the block of its
global tensor that ``Model.param_specs`` gives the rank).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import collectives as col
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import AttentionPlan, plan_attention
from repro_torch.models import moe as moe_mod
from repro_torch.models.moe import MoE, MoEPlan, plan_moe
from repro_torch.models.ssm import SSM, SSMPlan, plan_ssm


@dataclass(frozen=True)
class ModelPlan:
    cfg: ModelConfig
    tp: int
    attn: Optional[AttentionPlan]
    moe: Optional[MoEPlan]
    ssm: Optional[SSMPlan]
    vocab_padded: int

    @property
    def period(self) -> int:
        return self.cfg.moe_layer_period if self.cfg.is_moe else 1

    @property
    def scan_steps(self) -> int:
        return self.cfg.num_layers // self.period


def make_plan(cfg: ModelConfig, tp: int = 1, capacity_factor: float = 1.0) -> ModelPlan:
    attn = (plan_attention(cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, tp)
            if cfg.has_attention else None)
    moe = plan_moe(cfg, tp, capacity_factor) if cfg.is_moe else None
    ssm = plan_ssm(cfg, tp) if cfg.has_ssm else None
    return ModelPlan(cfg=cfg, tp=tp, attn=attn, moe=moe, ssm=ssm,
                     vocab_padded=L.ceil_to(cfg.vocab_size, max(256, tp)))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _ones(d: int, dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones((d,), dtype=dtype, device=device), requires_grad=False)


class Block(nn.Module):
    """One layer's parameters, named as the JAX sub-layer dict
    (``_sublayer_init``): ``ln1``, ``attn`` (with attention), ``ssm`` (with
    an SSM), and with an MLP width ``ln2`` and either ``moe`` (+ ``shared``)
    on a MoE layer or ``mlp``.  Absent sub-layers are None."""

    def __init__(self, plan: ModelPlan, is_moe_layer: bool, dtype: torch.dtype, device=None):
        super().__init__()
        cfg = plan.cfg
        self.ln1 = _ones(cfg.d_model, dtype, device)
        self.attn = (attn_mod.Attention(cfg.d_model, plan.attn, cfg.qkv_bias, dtype, device)
                     if cfg.has_attention else None)
        self.ssm = SSM(plan.ssm, dtype, device) if cfg.has_ssm else None
        self.ln2 = self.moe = self.shared = self.mlp = None
        if cfg.d_ff > 0:
            self.ln2 = _ones(cfg.d_model, dtype, device)
            if is_moe_layer:
                self.moe = MoE(plan.moe, cfg.gated_mlp, dtype, device)
                if cfg.shared_expert:
                    self.shared = L.MLP(cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype, device)
            else:
                self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype, device)


class Transformer(nn.Module):
    """The model's parameters: ``embed`` [Vpad, D] (``frontend_proj``
    [F, D] instead with a frontend), ``lm_head`` [Vpad, D] (absent when
    tied, always there with a frontend), ``final_norm`` [D] and one
    ``Block`` per layer.  ``period`` is the plan's: layer i is entry
    ``i % period`` of JAX's scan unit ``i // period``.

    ``blocks`` maps a parameter's name to the slices of its global tensor
    that this rank holds: the parameter is made at the block's shape and
    keeps the slices as ``local`` (``init_`` draws each global tensor, in
    the same order at every layout, and keeps the block).  The global
    layout is laid out on the ``meta`` device first, so no global tensor
    is ever allocated."""

    def __init__(self, plan: ModelPlan, device=None,
                 blocks: Optional[Mapping[str, Tuple[slice, ...]]] = None):
        super().__init__()
        if blocks is not None:
            self._build(plan, "meta")
            self._localize(blocks, device)
            return
        self._build(plan, device)

    def _build(self, plan: ModelPlan, device) -> None:
        cfg = plan.cfg
        dtype = L.dtype_of(cfg.dtype)
        self.period = plan.period

        def table(rows):
            return nn.Parameter(torch.empty((rows, cfg.d_model), dtype=dtype, device=device),
                                requires_grad=False)

        self.final_norm = _ones(cfg.d_model, dtype, device)
        self.embed = table(plan.vocab_padded) if cfg.frontend is None else None
        self.frontend_proj = table(cfg.frontend_dim) if cfg.frontend is not None else None
        self.lm_head = (table(plan.vocab_padded)
                        if not cfg.tie_embeddings or cfg.frontend is not None else None)
        mask = cfg.moe_layer_mask()
        self.layers = nn.ModuleList(Block(plan, mask[i], dtype, device)
                                    for i in range(cfg.num_layers))
        self.vocab_padded, self.d_model = plan.vocab_padded, cfg.d_model
        self.frontend_dim = cfg.frontend_dim

    def _localize(self, blocks: Mapping[str, Tuple[slice, ...]], device) -> None:
        """Give every parameter storage on ``device``, at its block's shape
        where ``blocks`` names one; the norms start at one."""
        for name, p in list(self.named_parameters()):
            owner_name, _, leaf = name.rpartition(".")
            owner = self.get_submodule(owner_name) if owner_name else self
            block = blocks.get(name)
            shape = p.shape if block is None else tuple(
                len(range(*s.indices(n))) for s, n in zip(block, p.shape))
            new = nn.Parameter(torch.empty(shape, dtype=p.dtype, device=device),
                               requires_grad=False)
            if block is not None and tuple(shape) != tuple(p.shape):
                new.local = tuple(block)
            if leaf in ("ln1", "ln2", "final_norm", "norm"):
                with torch.no_grad():
                    new.fill_(1.0)
            setattr(owner, leaf, new)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "Transformer":
        """The JAX ``init_params``: N(0, 0.02²) embedding and head (the
        padded vocab rows too), N(0, 1/F) ``frontend_proj``, ones for the
        norms, and per layer ``attn_init``, ``ssm_init``, ``moe_init`` and
        ``mlp_init``."""
        V, D = self.vocab_padded, self.d_model
        if self.embed is not None:
            L.fill_(self.embed, L.embed_init(V, D, gen, self.embed.dtype))
        if self.frontend_proj is not None:
            F_ = self.frontend_dim
            L.fill_(self.frontend_proj, L.normal((F_, D), F_ ** -0.5, gen,
                                                 self.frontend_proj.dtype))
        if self.lm_head is not None:
            L.fill_(self.lm_head, L.embed_init(V, D, gen, self.lm_head.dtype))
        for blk in self.layers:
            for sub in (blk.attn, blk.ssm, blk.moe, blk.shared, blk.mlp):
                if sub is not None:
                    sub.init_(gen)
        return self


# ---------------------------------------------------------------------------
# Sub-block application
# ---------------------------------------------------------------------------


class LayerCtx(NamedTuple):
    """Static context of a forward pass.  The JAX sharding constraints
    (``c_act``, ``c_head``, ``c_ffn``) have no counterpart: the layout is
    the parameters' blocks, and ``mesh`` names the collectives' groups."""
    plan: ModelPlan
    mode: str                     # "train" | "prefill" | "decode"
    window: int
    use_kernel: bool
    mesh: Any = None              # None on one device
    dp_axes: Tuple[str, ...] = ()
    block_kv: int = 1024
    ssd_chunk: int = 128
    ring: bool = False            # ring KV cache (long-context decode)
    attn_impl: str = "blocked"    # "blocked" | "pairs" (causal block skip)
    tp_reduce: Any = None         # explicit bf16 TP reduction (tp_reduce.py)
    remat: str = "block"          # "block" | "save_mixer" | "none" (train mode)


def _attn_sublayer(p: Block, h, ctx: LayerCtx, positions, cache, cache_len):
    """The attention's output (no residual) on the normed input ``h``, and
    its kv cache."""
    cfg = ctx.plan.cfg
    kv_cache = (cache["k"], cache["v"]) if ctx.mode == "decode" else None
    y, (k_new, v_new) = attn_mod.attn_apply(
        p.attn, h, ctx.plan.attn, cfg.rope_theta, positions,
        causal=True, window=ctx.window, block_kv=ctx.block_kv,
        use_kernel=ctx.use_kernel, cache=kv_cache, cache_len=cache_len, ring=ctx.ring,
        impl=ctx.attn_impl, mesh=ctx.mesh, tp_reduce=ctx.tp_reduce,
    )
    # decode: attn_apply already wrote the new token into the cache
    new_cache = {"k": k_new, "v": v_new} if ctx.mode in ("decode", "prefill") else None
    return y, new_cache


def _ssm_sublayer(p: Block, x, ctx: LayerCtx, cache):
    y, new_cache = ssm_mod.ssm_apply(p.ssm, x, ctx.plan.ssm, chunk=ctx.ssd_chunk,
                                     cache=cache, norm_eps=ctx.plan.cfg.norm_eps,
                                     mesh=ctx.mesh)
    return y, (None if ctx.mode == "train" else new_cache)


def _mixer_sublayer(p: Block, x, ctx: LayerCtx, positions, cache, cache_len):
    """Attention / SSM / hybrid mixer with residual; returns (x, cache
    entry ``{"kv": …, "ssm": …}`` or None)."""
    cfg = ctx.plan.cfg
    new_cache: Dict[str, Any] = {}
    kv_in = cache.get("kv") if cache else None
    ssm_in = cache.get("ssm") if cache else None
    h = L.rmsnorm(x, p.ln1, cfg.norm_eps)   # hybrid: both branches read it
    if cfg.hybrid:
        ya, kv = _attn_sublayer(p, h, ctx, positions, kv_in, cache_len)
        ys, sc = _ssm_sublayer(p, h, ctx, ssm_in)
        y = 0.5 * (ya + ys)
    elif cfg.has_attention:
        y, kv = _attn_sublayer(p, h, ctx, positions, kv_in, cache_len)
        sc = None
    else:
        y, sc = _ssm_sublayer(p, h, ctx, ssm_in)
        kv = None
    if kv is not None:
        new_cache["kv"] = kv
    if sc is not None:
        new_cache["ssm"] = sc
    return x + y, (new_cache or None)


def _ffn_sublayer(p: Block, x, ctx: LayerCtx):
    """MLP / MoE with residual; returns (x, aux loss)."""
    cfg = ctx.plan.cfg
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.d_ff == 0:
        return x, aux
    h = L.rmsnorm(x, p.ln2, cfg.norm_eps)
    if p.moe is not None:
        if ctx.mesh is not None:
            y, aux = moe_mod.moe_apply(h, p.moe, ctx.plan.moe, cfg.gated_mlp, ctx.mesh,
                                       dp_axes=ctx.dp_axes)
        else:
            y, aux = moe_local_reference(h, p.moe, ctx.plan.moe, cfg.gated_mlp)
        if p.shared is not None:
            y = y + L.mlp_apply(p.shared, h, cfg.gated_mlp, ctx.mesh, ctx.tp_reduce)
    else:
        y = L.mlp_apply(p.mlp, h, cfg.gated_mlp, ctx.mesh, ctx.tp_reduce)
    return x + y, aux


def moe_local_reference(x: torch.Tensor, weights: MoE, plan: MoEPlan, gated: bool):
    """Dense one-hot MoE (JAX's oracle and single-device path): every
    virtual expert runs on every token, and each token sums the outputs of
    its top-k experts' r virtual slices, weighted by the router's softmax.
    Returns (y [B, S, D] in x's dtype, aux loss)."""
    B, S, D = x.shape
    t = x.reshape(-1, D)
    logits = torch.einsum("td,de->te", t.float(), weights.router)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, plan.top_k, dim=-1)
    r = plan.virt_per_expert
    h1 = torch.einsum("td,edf->tef", t, weights.w1)
    if gated:
        h = F.silu(h1) * torch.einsum("td,edf->tef", t, weights.w3)
    else:
        h = F.gelu(h1, approximate="tanh")   # jax.nn.gelu's default
    out_e = torch.einsum("tef,efd->ted", h, weights.w2)   # [t, Ev, D]
    # combine: each selected logical expert e contributes its r virtual slices
    slots = (topi[:, :, None] * r + torch.arange(r, device=x.device)).reshape(t.shape[0], -1)
    w = topv.repeat_interleave(r, dim=-1)
    sel = torch.gather(out_e, 1, slots[:, :, None].expand(-1, -1, D))   # [t, kr, D]
    y = torch.einsum("tkd,tk->td", sel.float(), w)
    return y.reshape(B, S, D).to(x.dtype), _local_aux(probs, topi, plan)


def _local_aux(probs: torch.Tensor, topi: torch.Tensor, plan: MoEPlan) -> torch.Tensor:
    """Switch-style load-balancing loss E · Σ_e f_e · P_e over the top-1
    assignments."""
    E = plan.num_experts
    f = F.one_hot(topi[:, 0], E).float().mean(dim=0)
    return E * (f * probs.mean(dim=0)).sum()


REMATS = ("block", "save_mixer", "none")


def _train_unit(layers, x, ctx: LayerCtx, positions):
    """One unit of ``period`` layers under the remat policy; returns (x,
    the unit's aux loss).  ``"block"`` keeps only the unit's input for the
    backward pass and recomputes the unit (``jax.checkpoint(unit_apply)``);
    ``"save_mixer"`` also keeps each post-mixer residual and recomputes
    each sub-layer from its own input (JAX's
    ``save_only_these_names("mixer_out")``); ``"none"`` keeps every
    activation."""

    def mixer(p, h):
        return _mixer_sublayer(p, h, ctx, positions, None, None)[0]

    def unit(h):
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for p in layers:
            h, a = _ffn_sublayer(p, mixer(p, h), ctx)
            aux = aux + a
        return h, aux

    if ctx.remat == "none":
        return unit(x)
    if ctx.remat == "save_mixer":
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p in layers:
            h = checkpoint(mixer, p, x, use_reentrant=False)
            x, a = checkpoint(_ffn_sublayer, p, h, ctx, use_reentrant=False)
            aux = aux + a
        return x, aux
    if ctx.remat == "block":
        return checkpoint(unit, x, use_reentrant=False)
    raise ValueError(f"remat {ctx.remat!r} not in {REMATS}")


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------


Cache = List[Optional[Dict[str, Any]]]


def forward(
    params: Transformer,
    inputs: torch.Tensor,              # tokens [B, S] or embeddings [B, S, F]
    plan: ModelPlan,
    ctx: LayerCtx,
    cache: Optional[Cache] = None,     # one {"kv": {"k", "v"}, "ssm": SSMCache} per layer
    cache_len: Optional[int] = None,
):
    """Returns ``(x, head, new_cache, aux)``: the final-normed hidden states
    [B, S, D], the LM head table, the per-layer caches (prefill, decode;
    None in train mode) and the auxiliary loss summed over the layers."""
    cfg = plan.cfg
    if cfg.frontend is None:
        x = L.embed_lookup(params.embed, inputs, ctx.mesh)
    else:
        x = torch.einsum("bsf,fd->bsd", inputs.to(L.dtype_of(cfg.dtype)),
                         params.frontend_proj)
        if L.tp_width(ctx.mesh) > 1:   # frontend_proj holds a block of D
            x = col.gather_split(x, ctx.mesh, "model", dim=-1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    if ctx.mode == "decode":
        positions = positions + cache_len
    period = plan.period
    auxs = []
    new_cache: Cache = []
    for u in range(0, len(params.layers), period):
        layers = params.layers[u:u + period]
        if ctx.mode == "train":
            x, aux = _train_unit(layers, x, ctx, positions)
        else:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for i, layer in enumerate(layers, start=u):
                x, nc = _mixer_sublayer(layer, x, ctx, positions,
                                        cache[i] if cache is not None else None, cache_len)
                x, a = _ffn_sublayer(layer, x, ctx)
                aux = aux + a
                new_cache.append(nc)
        auxs.append(aux)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    head = params.lm_head if params.lm_head is not None else params.embed
    return x, head, (new_cache if ctx.mode != "train" else None), torch.stack(auxs).sum()
