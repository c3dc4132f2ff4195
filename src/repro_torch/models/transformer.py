"""Decoder backbone (port of ``models/transformer.py``): the dense family.

The JAX package scans over layers with ``[steps, …]`` stacked parameters;
here the parameters are one ``nn.Module`` per layer and the forward pass is
a Python loop over them.  A dense block is

    [norm → attn → +res] [norm → mlp → +res]

In train mode each block runs under the remat policy of ``LayerCtx.remat``
(``torch.utils.checkpoint`` where JAX wraps the scan body in
``jax.checkpoint``).  Parameters are made with ``requires_grad=False``,
for serving; ``Model.init_train_state`` switches it on.

The moe, ssm and hybrid families and the modality frontends are later
slices of the port (ROADMAP queue 1 item 14): ``check_supported`` refuses
them rather than running something else.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models.attention import AttentionPlan, plan_attention


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a configuration outside the dense
    family without frontend, the only one this slice of the port runs."""
    missing = [what for what, has in (("moe", cfg.is_moe), ("ssm", cfg.has_ssm),
                                      ("hybrid", cfg.hybrid),
                                      ("frontend", cfg.frontend is not None),
                                      ("attention-free", not cfg.has_attention),
                                      ("MLP-free", cfg.d_ff == 0)) if has]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the {'/'.join(missing)} model path is not ported yet "
            f"(ROADMAP queue 1 item 14); only dense configs without a frontend run")


@dataclass(frozen=True)
class ModelPlan:
    cfg: ModelConfig
    tp: int
    attn: AttentionPlan
    vocab_padded: int


def make_plan(cfg: ModelConfig, tp: int = 1) -> ModelPlan:
    check_supported(cfg)
    attn = plan_attention(cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, tp)
    return ModelPlan(cfg=cfg, tp=tp, attn=attn,
                     vocab_padded=L.ceil_to(cfg.vocab_size, max(256, tp)))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _ones(d: int, dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.ones((d,), dtype=dtype, device=device), requires_grad=False)


class Block(nn.Module):
    """One layer's parameters, named as the JAX sub-layer dict: ``ln1``,
    ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, plan: ModelPlan, dtype: torch.dtype, device=None):
        super().__init__()
        cfg = plan.cfg
        self.ln1 = _ones(cfg.d_model, dtype, device)
        self.attn = attn_mod.Attention(cfg.d_model, plan.attn, cfg.qkv_bias, dtype, device)
        self.ln2 = _ones(cfg.d_model, dtype, device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype, device)


class Transformer(nn.Module):
    """The model's parameters: ``embed`` [Vpad, D], ``lm_head`` [Vpad, D]
    (absent when tied), ``final_norm`` [D] and one ``Block`` per layer."""

    def __init__(self, plan: ModelPlan, device=None):
        super().__init__()
        cfg = plan.cfg
        dtype = L.dtype_of(cfg.dtype)

        def table():
            return nn.Parameter(torch.empty((plan.vocab_padded, cfg.d_model), dtype=dtype,
                                            device=device), requires_grad=False)

        self.final_norm = _ones(cfg.d_model, dtype, device)
        self.embed = table()
        self.lm_head = None if cfg.tie_embeddings else table()
        self.layers = nn.ModuleList(Block(plan, dtype, device) for _ in range(cfg.num_layers))

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "Transformer":
        """The JAX ``init_params``: N(0, 0.02²) embedding and head (the
        padded vocab rows too), ones for the norms, ``attn_init`` and
        ``mlp_init`` per layer."""
        for t in (self.embed, self.lm_head):
            if t is not None:
                t.copy_(L.embed_init(*t.shape, gen, t.dtype))
        for blk in self.layers:
            blk.attn.init_(gen)
            blk.mlp.init_(gen)
        return self


# ---------------------------------------------------------------------------
# Sub-block application
# ---------------------------------------------------------------------------


class LayerCtx(NamedTuple):
    """Static context of a forward pass.  The JAX fields for meshes,
    sharding constraints and the TP reduction have no counterpart on one
    device."""
    plan: ModelPlan
    mode: str                     # "train" | "prefill" | "decode"
    window: int
    use_kernel: bool
    block_kv: int = 1024
    ring: bool = False            # ring KV cache (long-context decode)
    attn_impl: str = "blocked"    # "blocked" | "pairs" (causal block skip)
    remat: str = "block"          # "block" | "save_mixer" | "none" (train mode)


def _attn_sublayer(p: Block, x, ctx: LayerCtx, positions, cache, cache_len):
    cfg = ctx.plan.cfg
    h = L.rmsnorm(x, p.ln1, cfg.norm_eps)
    kv_cache = (cache["k"], cache["v"]) if ctx.mode == "decode" else None
    y, (k_new, v_new) = attn_mod.attn_apply(
        p.attn, h, ctx.plan.attn, cfg.rope_theta, positions,
        causal=True, window=ctx.window, block_kv=ctx.block_kv,
        use_kernel=ctx.use_kernel, cache=kv_cache, cache_len=cache_len, ring=ctx.ring,
        impl=ctx.attn_impl,
    )
    # decode: attn_apply already wrote the new token into the cache
    new_cache = {"k": k_new, "v": v_new} if ctx.mode in ("decode", "prefill") else None
    return x + y, new_cache


def _ffn_sublayer(p: Block, x, ctx: LayerCtx):
    cfg = ctx.plan.cfg
    h = L.rmsnorm(x, p.ln2, cfg.norm_eps)
    return x + L.mlp_apply(p.mlp, h, cfg.gated_mlp)


REMATS = ("block", "save_mixer", "none")


def _train_block(p: Block, x, ctx: LayerCtx, positions):
    """One block under the remat policy: ``"block"`` keeps only the block's
    input for the backward pass and recomputes the block
    (``jax.checkpoint(unit_apply)``); ``"save_mixer"`` also keeps the
    post-attention residual and recomputes each sub-layer from its own
    input (JAX's ``save_only_these_names("mixer_out")``); ``"none"`` keeps
    every activation."""

    def mixer(h):
        return _attn_sublayer(p, h, ctx, positions, None, None)[0]

    def ffn(h):
        return _ffn_sublayer(p, h, ctx)

    if ctx.remat == "none":
        return ffn(mixer(x))
    if ctx.remat == "save_mixer":
        h = checkpoint(mixer, x, use_reentrant=False)
        return checkpoint(ffn, h, use_reentrant=False)
    if ctx.remat == "block":
        return checkpoint(lambda h: ffn(mixer(h)), x, use_reentrant=False)
    raise ValueError(f"remat {ctx.remat!r} not in {REMATS}")


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------


def forward(
    params: Transformer,
    inputs: torch.Tensor,              # tokens [B, S]
    plan: ModelPlan,
    ctx: LayerCtx,
    cache: Optional[List[Dict[str, torch.Tensor]]] = None,   # one {"k","v"} per layer
    cache_len: Optional[int] = None,
):
    """Returns ``(x, head, new_cache, aux)``: the final-normed hidden states
    [B, S, D], the LM head table, the per-layer caches (prefill, decode)
    and the auxiliary loss (zero: no experts)."""
    cfg = plan.cfg
    x = L.embed_lookup(params.embed, inputs)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    if ctx.mode == "decode":
        positions = positions + cache_len
    new_cache: List[Any] = []
    for i, layer in enumerate(params.layers):
        if ctx.mode == "train":
            x = _train_block(layer, x, ctx, positions)
            continue
        x, nc = _attn_sublayer(layer, x, ctx, positions,
                               cache[i] if cache is not None else None, cache_len)
        x = _ffn_sublayer(layer, x, ctx)
        new_cache.append(nc)
    x = L.rmsnorm(x, params.final_norm, cfg.norm_eps)
    head = params.lm_head if params.lm_head is not None else params.embed
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, head, (new_cache if ctx.mode != "train" else None), aux
