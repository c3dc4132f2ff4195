"""Top-level model API (port of ``models/model.py``): build, initialise,
train, prefill, decode.

``Model`` ties the backbone (``models/transformer.py``) to its plan, its
``ParallelConfig`` and its device.  ``make_prefill`` / ``make_decode_step``
return functions of ``(params, …)`` as in the JAX package, run under
``torch.inference_mode``.  The decode cache holds one entry per layer, as
JAX's: ``{"kv": {"k", "v"}}`` with attention (``[B, S_max, slots, H]``
tensors, written in place by each decode step; the JAX step donates its
cache buffer to the same effect) and ``{"ssm": SSMCache}`` with an SSM (the
recurrent state and the convolutions' tails, new tensors each step).  A
frontend model takes embeddings [B, S, F] in f32 where a token model takes
token ids [B, S].

Training: ``loss_fn`` is the chunked cross-entropy (plus 0.01 · aux /
layers for MoE), ``apply_grad_fixups`` ties the kv-replica gradients and
masks the padded q heads, SSD heads and vocab rows,
and ``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``.  The step carries a ``core.detection.MonitorState``: the
training loss is pushed through the K-stale ring exactly like a solver's
residual, so the stop decision never fences the step; the metrics stay
device tensors, and the host reads the previous step's (see
``launch/train.py``).  Parameters are updated in place, where the JAX step
donates its state; the optimizer state and the monitor are new tensors
each step.  Gradients and moments are dicts keyed by the parameters'
names (``Transformer.named_parameters()``).
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core import detection
from repro_torch.models import layers as L
from repro_torch.models.attention import q_valid_mask
from repro_torch.models.ssm import head_valid_mask, ssm_cache_init
from repro_torch.models.transformer import Cache, LayerCtx, Transformer, forward, make_plan
from repro_torch.optim.adamw import AdamState, AdamW, apply_updates, global_norm

Grads = Dict[str, torch.Tensor]

MONITOR_METRICS = ("loss", "update_norm", "grad_norm")


class TrainState(NamedTuple):
    params: Transformer           # updated in place by the train step
    opt: AdamState                # moments keyed by parameter name
    monitor: detection.MonitorState
    step: torch.Tensor            # i32


class Model:
    def __init__(self, cfg: ModelConfig, parallel: ParallelConfig = ParallelConfig(),
                 device: DeviceLike = None):
        self.cfg = cfg
        self.parallel = parallel
        self.plan = make_plan(cfg, 1)
        self.device = resolve_device(device)
        self._masks: Dict[tuple, torch.Tensor] = {}

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
            attn_impl=self.parallel.attn_impl,
            remat=self.parallel.remat,
        )

    # ------------------------------------------------------------------
    # Gradient fix-ups: tie kv replicas, mask padded heads/vocab
    # ------------------------------------------------------------------
    def _mask(self, kind: str, device) -> torch.Tensor:
        """The plan's ``q_valid_mask`` (kind "q") or per-channel SSD
        ``head_valid_mask`` (kind "ssm") on ``device``, made once per (plan,
        device): the mask is built on the host, and its copy to the card
        would wait for the card at every step."""
        key = (kind, self.plan, torch.device(device))
        if key not in self._masks:
            if kind == "q":
                self._masks[key] = q_valid_mask(self.plan.attn, device)
            else:
                sp = self.plan.ssm
                self._masks[key] = head_valid_mask(sp, device).repeat_interleave(sp.head_dim)
        return self._masks[key]

    def apply_grad_fixups(self, grads: Mapping[str, torch.Tensor]) -> Grads:
        """The JAX fix-ups on a ``{parameter name: gradient}`` dict: each
        group's kv replicas get the sum of their gradients; the ``wo`` rows
        of padded q heads, the ``out_proj`` rows of padded SSD heads and the
        padded vocab rows of ``embed`` / ``lm_head`` get zero."""
        ap = self.plan.attn
        grads = dict(grads)
        vmask = None
        for name, g in grads.items():
            path = name.rsplit(".", 2)
            leaf, owner = path[-1], (path[-2] if len(path) > 1 else "")
            if owner == "attn" and ap.kv_repl > 1 and leaf in ("wk", "wv", "bk", "bv"):
                s = g.shape                   # [D, slots, H] or [slots, H]
                gg = g.reshape(*s[:-2], ap.groups, ap.kv_repl, s[-1])
                grads[name] = gg.sum(-2, keepdim=True).expand(gg.shape).reshape(s)
            elif owner == "attn" and leaf == "wo":     # [slots, qps, H, D]
                grads[name] = g * self._mask("q", g.device).to(g.dtype)[:, :, None, None]
            elif owner == "ssm" and leaf == "out_proj":   # [di, D]
                grads[name] = g * self._mask("ssm", g.device).to(g.dtype)[:, None]
            elif name in ("embed", "lm_head"):
                if vmask is None:
                    vmask = torch.arange(self.plan.vocab_padded, device=g.device) \
                        < self.cfg.vocab_size
                grads[name] = g * vmask[:, None].to(g.dtype)
        return grads

    # ------------------------------------------------------------------
    # Loss
    # ------------------------------------------------------------------
    def _chunk_nll(self, xb: torch.Tensor, lb: torch.Tensor, head: torch.Tensor):
        """Summed NLL and target count of one sequence chunk."""
        vpad = self.plan.vocab_padded
        logits = L.lm_head(xb, head)  # [B, c, Vpad] f32
        vocab_ids = torch.arange(vpad, device=xb.device)
        logits = torch.where(vocab_ids < self.cfg.vocab_size, logits, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        # gold logit by a masked sum, as JAX takes it (over the vocab axis)
        sel = vocab_ids[None, None, :] == lb[..., None]
        gold = torch.where(sel, logits, 0.0).sum(dim=-1)
        valid = lb >= 0   # -1 = no target (sequence wraparound)
        return (torch.where(valid, lse - gold, 0.0).sum(),
                valid.to(torch.float32).sum())

    def loss_fn(self, params: Transformer, batch: Mapping[str, torch.Tensor],
                seq_chunk: int = 512):
        """Chunked softmax cross-entropy; returns (loss, metrics).  Each
        chunk's logits are recomputed in the backward pass (the JAX
        ``jax.checkpoint`` around the chunk), so one chunk's f32 logits are
        alive at a time."""
        inputs = batch["inputs"].to(self.device)
        labels = batch["labels"].to(self.device)
        x, head, _, aux = forward(params, inputs, self.plan, self._ctx("train"))
        S = x.shape[1]
        seq_chunk = min(seq_chunk, S)
        if S % seq_chunk:
            raise ValueError(f"sequence length {S} is not a multiple of seq_chunk {seq_chunk}")
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        ntok = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(0, S, seq_chunk):
            nll, n = checkpoint(self._chunk_nll, x[:, c:c + seq_chunk],
                                labels[:, c:c + seq_chunk], head, use_reentrant=False)
            total, ntok = total + nll, ntok + n
        nll = total / torch.clamp(ntok, min=1.0)
        loss = nll
        if self.cfg.is_moe:
            loss = loss + 0.01 * aux / max(self.cfg.num_layers, 1)
        return loss, {"nll": nll, "aux": aux}

    # ------------------------------------------------------------------
    # Train step
    # ------------------------------------------------------------------
    def _default_monitor(self) -> detection.MonitorConfig:
        return detection.MonitorConfig(
            mode=self.parallel.monitor_mode, eps=1e-2, eps_tilde=1e-2, ord=1.0,
            staleness=self.parallel.monitor_staleness)

    def _grads(self, params: Transformer, batch) -> tuple:
        """(loss, metrics, {name: gradient}) of one backward pass."""
        params.zero_grad(set_to_none=True)
        loss, metrics = self.loss_fn(params, batch)
        loss.backward()
        grads = {n: p.grad for n, p in params.named_parameters()}
        params.zero_grad(set_to_none=True)
        return loss.detach(), metrics, grads

    def make_train_step(
        self,
        optimizer: AdamW,
        monitor: Optional[detection.MonitorConfig] = None,
        microbatches: int = 1,
        accum_dtype: Optional[str] = None,   # None → f32; "bfloat16" for 100B+
        monitor_metric: str = "loss",   # loss | update_norm | grad_norm
    ):
        """``(train_step, monitor)``.  ``train_step(state, batch)`` returns
        the new ``TrainState`` (its parameters updated in place) and the
        metrics ``loss``, ``grad_norm`` and ``converged`` as device
        tensors: nothing in the step reads a value on the host."""
        if monitor_metric not in MONITOR_METRICS:
            raise ValueError(f"unknown monitor_metric {monitor_metric!r}")
        monitor = monitor or self._default_monitor()
        adt = L.dtype_of(accum_dtype) if accum_dtype else torch.float32

        def train_step(state: TrainState, batch):
            params = state.params
            if microbatches <= 1:
                loss, metrics, grads = self._grads(params, batch)
            else:
                # gradient accumulation: live activations scale with
                # B / microbatches
                mbs = [{k: v.reshape((microbatches, v.shape[0] // microbatches)
                                     + tuple(v.shape[1:]))[i] for k, v in batch.items()}
                       for i in range(microbatches)]
                gsum = {n: torch.zeros(p.shape, dtype=adt, device=p.device)
                        for n, p in params.named_parameters()}
                lsum = torch.zeros((), dtype=torch.float32, device=self.device)
                for b in mbs:
                    loss, _, grads = self._grads(params, b)
                    for n, g in grads.items():
                        gsum[n] += g.to(adt)
                    lsum = lsum + loss
                grads = {n: g / microbatches for n, g in gsum.items()}
                loss = lsum / microbatches
                metrics = {}
            grads = self.apply_grad_fixups(grads)
            named = dict(params.named_parameters())
            updates, opt, gnorm = optimizer.update(grads, state.opt, named)
            apply_updates(named, updates)
            # PFAIT: push the convergence metric through the K-stale ring;
            # the host reads ``converged`` a step later.  update_norm is
            # the fixed-point residual ‖x_{k+1} − x_k‖ (the paper's
            # convention); grad_norm / loss are the classic ML criteria.
            if monitor_metric == "update_norm":
                contribution = global_norm(updates)
            elif monitor_metric == "grad_norm":
                contribution = gnorm
            else:
                contribution = loss
            mon = detection.step(monitor, state.monitor, contribution)
            metrics = dict(metrics, loss=loss, grad_norm=gnorm, converged=mon.converged)
            return TrainState(params=params, opt=opt, monitor=mon,
                              step=state.step + 1), metrics

        return train_step, monitor

    def init_train_state(self, generator: torch.Generator, optimizer: AdamW,
                         monitor: Optional[detection.MonitorConfig] = None) -> TrainState:
        """A fresh training state with parameters drawn from ``generator``
        (``init``): every parameter the JAX tree differentiates (the norms,
        the embedding and the padded vocab rows included) gets
        ``requires_grad``."""
        params = self.init(generator).requires_grad_(True)
        monitor = monitor or self._default_monitor()
        return TrainState(
            params=params,
            opt=optimizer.init(dict(params.named_parameters())),
            monitor=detection.init_state(monitor, self.device),
            step=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    # ------------------------------------------------------------------
    # Serving
    # ------------------------------------------------------------------
    def cache_struct(self, batch: int, max_len: int, ring: bool = False) -> Cache:
        """Zeroed decode caches, one entry per layer: ``{"kv": {"k", "v"}}``
        with attention, ``{"ssm": SSMCache}`` with an SSM."""
        cfg, plan = self.cfg, self.plan
        S_kv = min(max_len, cfg.attn_window) if (ring and cfg.attn_window) else max_len
        dtype = L.dtype_of(cfg.dtype)
        cache: Cache = []
        for _ in range(cfg.num_layers):
            entry = {}
            if plan.attn is not None:
                shape = (batch, S_kv, plan.attn.slots, plan.attn.head_dim)
                entry["kv"] = {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                               "v": torch.zeros(shape, dtype=dtype, device=self.device)}
            if plan.ssm is not None:
                entry["ssm"] = ssm_cache_init(plan.ssm, batch, dtype, self.device)
            cache.append(entry)
        return cache

    def make_prefill(self):
        """prefill(params, inputs, max_len=None) → (last-position logits
        [B, 1, Vpad] f32, cache); inputs are tokens [B, S] or, with a
        frontend, embeddings [B, S, F].  The kv cache holds the S prompt
        positions, or ``max_len`` positions with the rest zero (room for
        decoding, as the JAX server pads it); the SSM cache is carried as
        the prefill leaves it."""

        @torch.inference_mode()
        def prefill(params: Transformer, inputs: torch.Tensor,
                    max_len: Optional[int] = None):
            inputs = inputs.to(self.device)
            x, head, cache, _ = forward(params, inputs, self.plan, self._ctx("prefill"))
            logits = L.lm_head(x[:, -1:], head)
            if max_len is not None and self.plan.attn is not None:
                B, S = inputs.shape[:2]
                for entry, full in zip(cache, self.cache_struct(B, max_len)):
                    for name in ("k", "v"):
                        full["kv"][name][:, :S] = entry["kv"][name]
                    entry["kv"] = full["kv"]
            return logits, cache

        return prefill

    def make_decode_step(self, ring: bool = False):
        """decode(params, cache, inputs, cache_len: int) → (logits
        [B, 1, Vpad] f32, cache); inputs are tokens [B, 1] or embeddings
        [B, 1, F].  The kv cache is written in place, the SSM entries are
        new."""

        @torch.inference_mode()
        def decode(params: Transformer, cache: Cache, tokens: torch.Tensor, cache_len: int):
            x, head, new_cache, _ = forward(
                params, tokens.to(self.device), self.plan, self._ctx("decode", ring=ring),
                cache=cache, cache_len=int(cache_len))
            return L.lm_head(x, head), new_cache

        return decode
