"""Top-level model API for serving (port of the serving part of
``models/model.py``): build, initialise, prefill, decode.

``Model`` ties the backbone (``models/transformer.py``) to its plan and
device.  ``make_prefill`` / ``make_decode_step`` return functions of
``(params, …)`` as in the JAX package, run under ``torch.inference_mode``.
The decode cache is one ``{"k", "v"}`` dict of ``[B, S_max, slots, H]``
tensors per layer, written in place by each decode step (the JAX step
donates its cache buffer to the same effect).  Training (``loss_fn``, the
train step, gradient fix-ups) comes with a later slice.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import LayerCtx, Transformer, forward, make_plan

Cache = List[Dict[str, torch.Tensor]]


class Model:
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.plan = make_plan(cfg, 1)      # raises for the families not ported yet
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    # Params
    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Transformer:
        """Parameters on the model's device, drawn from ``generator`` (on
        any device) with the JAX initialisers' distributions."""
        return Transformer(self.plan, self.device).init_(generator)

    # ------------------------------------------------------------------
    # Forward context
    # ------------------------------------------------------------------
    def _ctx(self, mode: str, ring: bool = False) -> LayerCtx:
        return LayerCtx(
            plan=self.plan,
            mode=mode,
            window=self.cfg.attn_window,
            # The one deliberate difference from the JAX ``_ctx``, which
            # passes use_kernel=False in every mode: prefill goes through
            # the flash-attention dispatcher.  A CPU tensor takes the same
            # ``attention_fwd`` (block_kv 1024) the JAX model runs, so the
            # numbers are the JAX model's; a CUDA tensor takes the kernel,
            # the path a TPU takes through the Pallas kernel.
            use_kernel=(mode == "prefill"),
            ring=ring,
        )

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------
    def cache_struct(self, batch: int, max_len: int, ring: bool = False) -> Cache:
        """Zeroed decode caches, one ``{"k", "v"}`` per layer."""
        cfg, ap = self.cfg, self.plan.attn
        S_kv = min(max_len, cfg.attn_window) if (ring and cfg.attn_window) else max_len
        shape = (batch, S_kv, ap.slots, ap.head_dim)
        dtype = L.dtype_of(cfg.dtype)
        return [{"k": torch.zeros(shape, dtype=dtype, device=self.device),
                 "v": torch.zeros(shape, dtype=dtype, device=self.device)}
                for _ in range(cfg.num_layers)]

    def make_prefill(self):
        """prefill(params, inputs [B, S], max_len=None) → (last-position
        logits [B, 1, Vpad] f32, cache).  The cache holds the S prompt
        positions, or ``max_len`` positions with the rest zero (room for
        decoding, as the JAX server pads it)."""

        @torch.inference_mode()
        def prefill(params: Transformer, inputs: torch.Tensor,
                    max_len: Optional[int] = None):
            inputs = inputs.to(self.device)
            x, head, cache, _ = forward(params, inputs, self.plan, self._ctx("prefill"))
            logits = L.lm_head(x[:, -1:], head)
            if max_len is not None:
                B, S = inputs.shape
                full = self.cache_struct(B, max_len)
                for dst, src in zip(full, cache):
                    for name in ("k", "v"):
                        dst[name][:, :S] = src[name]
                cache = full
            return logits, cache

        return prefill

    def make_decode_step(self, ring: bool = False):
        """decode(params, cache, tokens [B, 1], cache_len: int) →
        (logits [B, 1, Vpad] f32, cache written in place)."""

        @torch.inference_mode()
        def decode(params: Transformer, cache: Cache, tokens: torch.Tensor, cache_len: int):
            x, head, new_cache, _ = forward(
                params, tokens.to(self.device), self.plan, self._ctx("decode", ring=ring),
                cache=cache, cache_len=int(cache_len))
            return L.lm_head(x, head), new_cache

        return decode
