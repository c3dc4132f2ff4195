"""Top-level model API (port of ``models/model.py``): build, shard,
initialise, train, prefill, decode.

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

On a mesh (``launch.mesh.ModelMesh``, axes ``("data", "model")`` or
``("pod", "data", "model")``) the plan is JAX's at the ``model`` width
and every parameter is this rank's block of its global tensor under
``param_specs`` (JAX's specs, keyed by parameter name where JAX's are a
tree; ``tree_path`` maps a name to JAX's path).  The collectives GSPMD
inserts from the specs are explicit (``models/collectives.py``): the
attention and MLPs are column- then row-parallel, the embedding
vocab-parallel, the LM head vocab-sharded with the loss's logsumexp
taken across the shards, the MoE layer expert-parallel
(``moe.moe_apply``), and the batch rows split over the data-parallel
axes, whose ranks sum their gradients.  The SSM mixer is column- then
row-parallel over its heads (``ssm.ssm_apply``).  Under dense FSDP
(``ParallelConfig.fsdp``, the default, with ``data`` wider than 1) every
weight whose spec names ``data`` is stored as this rank's block and
all-gathered just before use, its gradient reduce-scattered back
(``layers.whole``); the MoE experts keep their ``data`` block and run the
expert-TP branch of ``moe.moe_apply`` instead.  A gradient that arrives
summed over an axis its leaf is split on is not summed there again.
``make_prefill`` and ``make_decode_step`` return the full-vocabulary
logits, gathered over ``model``.  On a dry rank (``launch.mesh.dry_rank``)
the same program runs on ``meta`` tensors (``launch/dryrun.py``).
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.core import detection
from repro_torch.launch.mesh import P, dp_axes_of, spec_axes, spec_slices
from repro_torch.models import collectives as col
from repro_torch.models import layers as L
from repro_torch.models.attention import q_valid_mask
from repro_torch.models.ssm import SSMCache, head_valid_mask, ssm_cache_init
from repro_torch.models.transformer import Cache, LayerCtx, Transformer, forward, make_plan
from repro_torch.optim.adamw import AdamState, AdamW, apply_updates, global_norm

Grads = Dict[str, torch.Tensor]

MONITOR_METRICS = ("loss", "update_norm", "grad_norm")


class TrainState(NamedTuple):
    params: Transformer           # updated in place by the train step
    opt: AdamState                # moments keyed by parameter name
    monitor: detection.MonitorState
    step: torch.Tensor            # i32


def tree_path(name: str, period: int = 1) -> Tuple[tuple, Optional[int]]:
    """JAX's tree path of the parameter ``name`` and, for a layer's
    parameter, its index along the stacked ``[steps]`` axis: layer i is
    entry ``i % period`` of unit ``i // period``
    (``layers.3.attn.wq`` at period 2 → ``(("layers", 1, "attn", "wq"),
    1)``)."""
    if not name.startswith("layers."):
        return (name,), None
    _, i, rest = name.split(".", 2)
    return ("layers", int(i) % period, *rest.split(".")), int(i) // period


class Model:
    def __init__(self, cfg: ModelConfig, mesh=None,
                 parallel: ParallelConfig = ParallelConfig(),
                 capacity_factor: float = 1.0, device: DeviceLike = None):
        self.cfg = cfg
        self.mesh = mesh
        self.parallel = parallel
        tp = int(mesh.shape["model"]) if mesh is not None else 1
        self.plan = make_plan(cfg, tp, capacity_factor)
        self.dp_axes = dp_axes_of(mesh) if mesh is not None else ()
        self._fsdp = "data" if (parallel.fsdp and mesh is not None) else None
        if device is None and mesh is not None and mesh.device is not None:
            device = mesh.device
        self.device = resolve_device(device)
        self._masks: Dict[tuple, torch.Tensor] = {}
        self._specs: Optional[Dict[str, P]] = None
        self._blocks: Optional[Dict[str, Tuple[slice, ...]]] = None
        self._split: Optional[Dict[str, Tuple[str, ...]]] = None

    @property
    def tp(self) -> int:
        return self.plan.tp

    def _dp_live(self) -> Tuple[str, ...]:
        """The data-parallel axes wider than 1."""
        return tuple(a for a in self.dp_axes if self.mesh.size(a) > 1)

    def _check_runnable(self) -> None:
        """Refuse a mesh that only describes a layout."""
        mesh = self.mesh
        if mesh is not None and mesh.coords is None:
            raise ValueError(f"mesh {mesh.shape} describes a layout: no rank here has a "
                             "place on it (specs only; a dry rank is launch.mesh.dry_rank)")

    # ------------------------------------------------------------------
    # Params
    # ------------------------------------------------------------------
    def empty_params(self) -> Transformer:
        """This rank's parameters on the model's device, allocated and not
        drawn (the norms at one): a weight split over ``data`` under FSDP
        carries ``fsdp_gather = ("data", dim)`` for ``layers.whole``.  On
        ``meta`` nothing is allocated."""
        self._check_runnable()
        params = Transformer(self.plan, self.device, self.param_blocks())
        gathers = self._gathers()
        for name, p in params.named_parameters():
            dim = gathers.get(name)
            if dim is not None:
                p.fsdp_gather = (self._fsdp, dim)
        return params

    def init(self, generator: torch.Generator) -> Transformer:
        """Parameters on the model's device, drawn from ``generator`` (on
        any device) with the JAX initialisers' distributions; on a mesh,
        this rank's blocks of the same global draws."""
        return self.empty_params().init_(generator)

    def _gathers(self) -> Dict[str, int]:
        """``{name: dim}`` of the dense weights stored split over a ``data``
        axis wider than 1 (FSDP), each gathered along ``dim`` before use.
        The MoE experts are not: their ``data`` block is the expert-TP
        split ``moe.moe_apply`` runs on."""
        if self._fsdp is None or self.mesh is None or self.mesh.size(self._fsdp) == 1:
            return {}
        return {n: next(d for d, a in enumerate(spec) if self._fsdp in spec_axes(a))
                for n, spec in self.param_specs().items()
                if ".moe." not in n and any(self._fsdp in spec_axes(a) for a in spec)}

    def _sublayer_specs(self, is_moe_layer: bool) -> Dict[str, P]:
        """JAX's ``_sublayer_specs`` without the stacked ``[steps]`` axis,
        keyed by the parameter's name within its ``Block``."""
        cfg, d = self.cfg, self._fsdp
        sp: Dict[str, P] = {"ln1": P(None)}
        if cfg.has_attention:
            sp.update({"attn.wq": P(d, "model", None, None), "attn.wk": P(d, "model", None),
                       "attn.wv": P(d, "model", None), "attn.wo": P("model", None, None, d)})
            if cfg.qkv_bias:
                sp.update({"attn.bq": P("model", None, None), "attn.bk": P("model", None),
                           "attn.bv": P("model", None)})
        if cfg.has_ssm:
            for k, v in {"w_z": P(d, "model"), "w_x": P(d, "model"), "w_B": P(d, None),
                         "w_C": P(d, None), "w_dt": P(d, "model"), "conv_x": P(None, "model"),
                         "conv_B": P(None, None), "conv_C": P(None, None),
                         "A_log": P("model"), "D_skip": P("model"), "dt_bias": P("model"),
                         "norm": P("model"), "out_proj": P("model", d)}.items():
                sp["ssm." + k] = v
        if cfg.d_ff > 0:
            sp["ln2"] = P(None)
            mlp = {"w1": P(d, "model"), "w2": P("model", d)}
            if cfg.gated_mlp:
                mlp["w3"] = P(d, "model")
            if is_moe_layer:
                # EP over model, expert-TP over data on d_ff (see moe.py)
                moe = {"router": P(None, None), "w1": P("model", None, d),
                       "w2": P("model", d, None)}
                if cfg.gated_mlp:
                    moe["w3"] = P("model", None, d)
                sp.update({"moe." + k: v for k, v in moe.items()})
                if cfg.shared_expert:
                    sp.update({"shared." + k: v for k, v in mlp.items()})
            else:
                sp.update({"mlp." + k: v for k, v in mlp.items()})
        return sp

    def param_specs(self) -> Dict[str, P]:
        """``{parameter name: P}``: JAX's ``param_specs`` leaf for leaf (a
        layer's spec without the stacked axis; ``tree_path`` gives each
        name's place in JAX's tree)."""
        if self._specs is not None:
            return dict(self._specs)
        cfg = self.cfg
        mask = cfg.moe_layer_mask()
        specs: Dict[str, P] = {"final_norm": P(None)}
        if cfg.frontend is None:
            # vocab-sharded: the lookup is clamp + mask + all-reduce, and
            # the tied LM head needs no reshard
            specs["embed"] = P("model", None)
        else:
            specs["frontend_proj"] = P(None, "model")
        if not cfg.tie_embeddings or cfg.frontend is not None:
            # vocab-sharded, D replicated: the loss's logits stay sharded
            specs["lm_head"] = P("model", None)
        for i in range(cfg.num_layers):
            for k, v in self._sublayer_specs(mask[i]).items():
                specs[f"layers.{i}.{k}"] = v
        self._specs = specs
        return dict(specs)

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """The global shape of every parameter (no storage is allocated)."""
        return {n: tuple(p.shape) for n, p in Transformer(self.plan, "meta").named_parameters()}

    def param_blocks(self) -> Optional[Dict[str, Tuple[slice, ...]]]:
        """``{name: slices}`` of the block of each global parameter this
        rank holds, or None without a mesh."""
        if self.mesh is None:
            return None
        if self._blocks is None:
            specs = self.param_specs()
            self._blocks = {n: spec_slices(specs[n], shape, self.mesh)
                            for n, shape in self.param_shapes().items()}
        return self._blocks

    def param_shardings(self) -> Dict[str, Callable[[torch.Tensor], torch.Tensor]]:
        """``{name: fn}``: ``fn(global tensor)`` is this rank's block of it."""
        if self.mesh is None:
            raise ValueError("param_shardings needs a mesh")
        return {n: (lambda t, sl=sl: t[sl]) for n, sl in self.param_blocks().items()}

    def _split_axes(self, name: str) -> Tuple[str, ...]:
        """The mesh axes wider than 1 that parameter ``name`` is split
        over, in the mesh's order."""
        if self._split is None:
            self._split = {}
            for n, spec in self.param_specs().items():
                named = {a for part in spec for a in spec_axes(part)}
                self._split[n] = tuple(a for a in self.mesh.axis_names
                                       if a in named and self.mesh.size(a) > 1)
        return self._split[name]

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
            mesh=self.mesh,
            dp_axes=self.dp_axes,
            ring=ring,
            attn_impl=self.parallel.attn_impl,
            tp_reduce=self._tp_reduce() if mode == "train" else None,
            remat=self.parallel.remat,
        )

    def _tp_reduce(self):
        if not self.parallel.tp_reduce_bf16 or self.mesh is None:
            return None
        from repro_torch.models.tp_reduce import tp_matmul_psum

        return partial(tp_matmul_psum, mesh=self.mesh, dp_axes=self.dp_axes)

    # ------------------------------------------------------------------
    # Gradient fix-ups: tie kv replicas, mask padded heads/vocab
    # ------------------------------------------------------------------
    def _rows(self, name: str) -> slice:
        """The block of dim 0 of parameter ``name`` this rank holds."""
        blocks = self.param_blocks()
        return blocks[name][0] if blocks is not None else slice(None)

    def _tie_replicas(self, g: torch.Tensor) -> torch.Tensor:
        """Sum a kv replica's gradient over the replicas of its group: each
        rank holds one slot (replicas exist only where the kv groups are
        fewer than tp), so the sum runs over ranks."""
        ap = self.plan.attn
        slot_dim = g.dim() - 2                    # [D, 1, H] or [1, H]
        every = col.all_gather(g.contiguous(), self.mesh, "model", dim=slot_dim)
        s = every.shape
        gg = every.reshape(*s[:slot_dim], ap.groups, ap.kv_repl, s[-1]).sum(slot_dim + 1)
        return gg.narrow(slot_dim, self.mesh.index("model") // ap.kv_repl, 1)

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
        for name, g in grads.items():
            path = name.rsplit(".", 2)
            leaf, owner = path[-1], (path[-2] if len(path) > 1 else "")
            if owner == "attn" and ap.kv_repl > 1 and leaf in ("wk", "wv", "bk", "bv"):
                s = g.shape                   # [D, slots, H] or [slots, H]
                if s[-2] != ap.slots:         # one slot a rank: tie across ranks
                    grads[name] = self._tie_replicas(g)
                    continue
                gg = g.reshape(*s[:-2], ap.groups, ap.kv_repl, s[-1])
                grads[name] = gg.sum(-2, keepdim=True).expand(gg.shape).reshape(s)
            elif owner == "attn" and leaf == "wo":     # [slots, qps, H, D]
                mask = self._mask("q", g.device)[self._rows(name)]
                grads[name] = g * mask.to(g.dtype)[:, :, None, None]
            elif owner == "ssm" and leaf == "out_proj":   # [di, D]
                mask = self._mask("ssm", g.device)[self._rows(name)]
                grads[name] = g * mask.to(g.dtype)[:, None]
            elif name in ("embed", "lm_head"):
                vocab_ids = torch.arange(self.plan.vocab_padded, device=g.device)
                vmask = vocab_ids[self._rows(name)] < self.cfg.vocab_size
                grads[name] = g * vmask[:, None].to(g.dtype)
        return grads

    # ------------------------------------------------------------------
    # Loss
    # ------------------------------------------------------------------
    def _chunk_nll_sharded(self, xb: torch.Tensor, lb: torch.Tensor, head: torch.Tensor):
        """``_chunk_nll`` over a vocab-sharded head: each rank holds a block
        of the logits; the logsumexp is taken across the blocks (an
        all-reduce of the max, then of the sum of exponentials) and the
        gold logit is a masked sum, all-reduced; padded vocab rows are
        masked out."""
        mesh = self.mesh
        xb = col.copy_to(xb, mesh, "model")
        logits = L.lm_head(xb, head)  # [B, c, Vpad / tp] f32
        n = head.shape[0]
        vocab_ids = torch.arange(n, device=xb.device) + mesh.index("model") * n
        logits = torch.where(vocab_ids < self.cfg.vocab_size, logits, -1e30)
        with torch.no_grad():
            m = col.all_reduce(logits.amax(dim=-1, keepdim=True), mesh, "model",
                               op=dist.ReduceOp.MAX)
        se = col.reduce_from(torch.exp(logits - m).sum(dim=-1), mesh, "model")
        lse = m.squeeze(-1) + torch.log(se)
        sel = vocab_ids[None, None, :] == lb[..., None]
        gold = col.reduce_from(torch.where(sel, logits, 0.0).sum(dim=-1), mesh, "model")
        valid = lb >= 0   # -1 = no target (sequence wraparound)
        return (torch.where(valid, lse - gold, 0.0).sum(),
                valid.to(torch.float32).sum())

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
        alive at a time.  On a mesh ``batch`` holds this rank's rows, and
        the loss is the global batch's: the NLL sums and target counts are
        all-reduced over the data-parallel axes."""
        self._check_runnable()
        inputs = batch["inputs"].to(self.device)
        labels = batch["labels"].to(self.device)
        x, head, _, aux = forward(params, inputs, self.plan, self._ctx("train"))
        chunk_nll = self._chunk_nll_sharded if self.tp > 1 else self._chunk_nll
        S = x.shape[1]
        seq_chunk = min(seq_chunk, S)
        if S % seq_chunk:
            raise ValueError(f"sequence length {S} is not a multiple of seq_chunk {seq_chunk}")
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        ntok = torch.zeros((), dtype=torch.float32, device=x.device)
        for c in range(0, S, seq_chunk):
            nll, n = checkpoint(chunk_nll, x[:, c:c + seq_chunk],
                                labels[:, c:c + seq_chunk], head, use_reentrant=False)
            total, ntok = total + nll, ntok + n
        if self.mesh is not None and self._dp_live():
            total = col.reduce_from(total, self.mesh, self._dp_live())
            ntok = col.all_reduce(ntok.detach(), self.mesh, self._dp_live())
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
        if self.mesh is not None and self._dp_live():
            grads = self._sum_over_data(grads)
        return loss.detach(), metrics, grads

    def _sum_over_data(self, grads: Grads) -> Grads:
        """Each gradient summed over the data-parallel ranks it is not
        split on (each rank's gradient its rows' part): one all-reduce per
        (set of axes, dtype), over the gradients laid end to end.  A leaf
        split over ``data`` arrives summed there already: a gathered weight's
        gradient is reduce-scattered (``layers.whole``), and an expert's
        ``data`` block saw every rank's tokens (``moe.moe_apply``)."""
        out = dict(grads)
        live = self._dp_live()
        groups: Dict[tuple, List[str]] = {}
        for n, g in grads.items():
            axes = tuple(a for a in live if a not in self._split_axes(n))
            if axes:
                groups.setdefault((axes, str(g.dtype)), []).append(n)
        for (axes, _), names in sorted(groups.items()):
            flat = col.all_reduce(torch.cat([grads[n].reshape(-1) for n in names]),
                                  self.mesh, axes)
            for n, piece in zip(names, flat.split([grads[n].numel() for n in names])):
                out[n] = piece.view_as(grads[n])
        return out

    def global_norm(self, tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The norm of the global tensors of which ``tree`` holds this
        rank's blocks: the squares of a leaf split over some axes are summed
        over those axes' ranks, a replicated leaf counted once
        (``global_norm`` without a mesh)."""
        if self.mesh is None:
            return global_norm(tree)
        parts: Dict[Tuple[str, ...], torch.Tensor] = {}
        for name, g in tree.items():
            axes = self._split_axes(name)
            sq = torch.sum(g.to(torch.float32) ** 2)
            parts[axes] = parts[axes] + sq if axes in parts else sq
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for axes, sq in sorted(parts.items()):
            for a in axes:
                sq = col.all_reduce(sq, self.mesh, a)
            total = total + sq
        return torch.sqrt(total)

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
            updates, opt, gnorm = optimizer.update(grads, state.opt, named,
                                                   gnorm=self.global_norm(grads))
            apply_updates(named, updates)
            # PFAIT: push the convergence metric through the K-stale ring;
            # the host reads ``converged`` a step later.  update_norm is
            # the fixed-point residual ‖x_{k+1} − x_k‖ (the paper's
            # convention); grad_norm / loss are the classic ML criteria.
            if monitor_metric == "update_norm":
                contribution = self.global_norm(updates)
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
        (``init``)."""
        return self.train_state_of(self.init(generator), optimizer, monitor)

    def train_state_of(self, params: Transformer, optimizer: AdamW,
                       monitor: Optional[detection.MonitorConfig] = None) -> TrainState:
        """A fresh training state around ``params`` (zero moments and
        steps): every parameter the JAX tree differentiates (the norms, the
        embedding and the padded vocab rows included) gets
        ``requires_grad``."""
        params = params.requires_grad_(True)
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
    def cache_struct(self, batch: int, max_len: int, ring: bool = False,
                     as_struct: bool = False) -> Cache:
        """Zeroed decode caches, one entry per layer: ``{"kv": {"k", "v"}}``
        with attention, ``{"ssm": SSMCache}`` with an SSM; on a mesh, of
        this rank's kv slots and SSD heads for its ``batch`` rows.  With ``as_struct``
        the global ``(shape, dtype)`` of each leaf instead (JAX's
        ``ShapeDtypeStruct``s), ``batch`` the global batch."""
        cfg, plan = self.cfg, self.plan
        S_kv = min(max_len, cfg.attn_window) if (ring and cfg.attn_window) else max_len
        dtype = L.dtype_of(cfg.dtype)
        slots = plan.attn.slots if plan.attn is not None else 0
        if not as_struct and plan.attn is not None and self.tp > 1:
            slots //= self.tp

        def mk(shape, dt):
            if as_struct:
                return (shape, dt)
            return torch.zeros(shape, dtype=dt, device=self.device)

        cache: Cache = []
        for _ in range(cfg.num_layers):
            entry = {}
            if plan.attn is not None:
                shape = (batch, S_kv, slots, plan.attn.head_dim)
                entry["kv"] = {"k": mk(shape, dtype), "v": mk(shape, dtype)}
            if plan.ssm is not None:
                if as_struct:
                    sp, gn = plan.ssm, plan.ssm.groups * plan.ssm.state
                    W = sp.conv_width - 1
                    entry["ssm"] = SSMCache(
                        h=mk((batch, sp.heads_padded, sp.head_dim, sp.state), torch.float32),
                        conv_x=mk((batch, W, sp.d_inner), dtype),
                        conv_B=mk((batch, W, gn), dtype), conv_C=mk((batch, W, gn), dtype))
                else:
                    entry["ssm"] = ssm_cache_init(plan.ssm, batch, dtype, self.device,
                                                  tp=self.tp)
            cache.append(entry)
        return cache

    def cache_specs(self, batch_shardable: bool = True) -> List[Dict[str, Any]]:
        """JAX's ``cache_specs``, one entry per layer (without the stacked
        axis): batch rows over the data-parallel axes, kv slots and SSD
        heads over ``model``."""
        cfg = self.cfg
        dp = self.dp_axes if batch_shardable else None
        out = []
        for _ in range(cfg.num_layers):
            entry: Dict[str, Any] = {}
            if cfg.has_attention:
                entry["kv"] = {"k": P(dp, None, "model", None), "v": P(dp, None, "model", None)}
            if cfg.has_ssm:
                entry["ssm"] = SSMCache(h=P(dp, "model", None, None), conv_x=P(dp, None, "model"),
                                        conv_B=P(dp, None, None), conv_C=P(dp, None, None))
            out.append(entry)
        return out

    def train_state_specs(self, optimizer: AdamW) -> TrainState:
        """JAX's ``train_state_specs``: the parameters' specs for the
        parameters and both moments, replicated scalars for the rest."""
        ps = self.param_specs()
        return TrainState(params=ps, opt=AdamState(step=P(), m=ps, v=ps),
                          monitor=detection.MonitorState(
                              *(P() for _ in detection.MonitorState._fields)),
                          step=P())

    def batch_spec(self, shape: ShapeConfig) -> P:
        B = shape.global_batch
        ndev = self.mesh.size(self.dp_axes) if self.mesh is not None else 1
        return P(self.dp_axes if (ndev > 1 and B % ndev == 0) else None)

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """``{name: ((shape, dtype), P)}`` of the step the shape implies
        (JAX's ``input_specs``, shapes and dtypes where JAX gives
        ``ShapeDtypeStruct``s); a decode step's ``cache`` is
        ``(cache_struct(as_struct=True), cache_specs)``."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        bspec = self.batch_spec(shape)
        bp = bspec[0] if len(bspec) else None
        dt = L.dtype_of(cfg.dtype)

        def tokens(n):
            if cfg.frontend is None:
                return ((B, n), torch.int32), P(bp, None)
            return ((B, n, cfg.frontend_dim), dt), P(bp, None, None)

        out: Dict[str, Any] = {}
        if shape.kind == "train":
            out["inputs"] = tokens(S)
            out["labels"] = (((B, S), torch.int32), P(bp, None))
        elif shape.kind == "prefill":
            out["inputs"] = tokens(S)
        else:  # decode
            ring = shape.name == "long_500k" and cfg.attn_window > 0
            out["inputs"] = tokens(1)
            out["cache"] = (self.cache_struct(B, S, ring=ring, as_struct=True),
                            self.cache_specs(batch_shardable=(bp is not None)))
            out["cache_len"] = (((), torch.int32), P())
        return out

    def _full_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The logits of every vocabulary block, gathered over ``model``."""
        return col.all_gather(logits, self.mesh, "model", dim=-1) if self.tp > 1 else logits

    def make_prefill(self):
        """prefill(params, inputs, max_len=None) → (last-position logits
        [B, 1, Vpad] f32, cache); inputs are tokens [B, S] or, with a
        frontend, embeddings [B, S, F].  The kv cache holds the S prompt
        positions, or ``max_len`` positions with the rest zero (room for
        decoding, as the JAX server pads it); the SSM cache is carried as
        the prefill leaves it."""

        self._check_runnable()

        @torch.inference_mode()
        def prefill(params: Transformer, inputs: torch.Tensor,
                    max_len: Optional[int] = None):
            inputs = inputs.to(self.device)
            x, head, cache, _ = forward(params, inputs, self.plan, self._ctx("prefill"))
            logits = self._full_logits(L.lm_head(x[:, -1:], head))
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

        self._check_runnable()

        @torch.inference_mode()
        def decode(params: Transformer, cache: Cache, tokens: torch.Tensor, cache_len: int):
            x, head, new_cache, _ = forward(
                params, tokens.to(self.device), self.plan, self._ctx("decode", ring=ring),
                cache=cache, cache_len=int(cache_len))
            return self._full_logits(L.lm_head(x, head)), new_cache

        return decode
