"""Model configuration: the ``ModelConfig`` dataclass and ``reduced``.

A copy of the JAX package's ``configs/base.py`` (the port imports nothing
of it): every assigned architecture is a ``ModelConfig``, field for field
the same, and the registry (``configs/registry.py``) resolves ``--arch``
and ``--shape`` strings to these objects.  ``ShapeConfig``,
``ParallelConfig`` and ``RunConfig`` are the JAX package's, field for
field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Decoder-style backbone configuration (all 10 assigned archs fit)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    vocab_size: int
    # --- attention ---
    num_heads: int = 0           # 0 => attention-free (pure SSM)
    num_kv_heads: int = 0        # GQA KV heads
    head_dim: int = 0            # 0 => d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_window: int = 0         # 0 => full causal; >0 => sliding window
    # --- MLP / MoE ---
    d_ff: int = 0
    gated_mlp: bool = True       # SwiGLU (3 mats) vs classic MLP (2 mats)
    num_experts: int = 0         # 0 => dense MLP
    experts_per_token: int = 0
    moe_layer_period: int = 1    # 1 => every layer MoE; 2 => alternating (llama4)
    shared_expert: bool = False  # llama4-style always-on shared expert
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0           # N: state dimension per group; 0 => no SSM
    ssm_heads: int = 0           # number of SSD heads (derived if 0)
    ssm_head_dim: int = 64       # P: channels per SSD head
    ssm_groups: int = 1          # B/C groups (shared across heads in a group)
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    # --- hybrid (hymba): attention and SSM in parallel within one block ---
    hybrid: bool = False
    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # modality frontend stub: if set, inputs are precomputed embeddings
    # of shape [batch, seq, frontend_dim] instead of token ids.
    frontend: Optional[str] = None   # None | "audio_codec" | "vision_anyres"
    frontend_dim: int = 0

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.ssm_state > 0 and not self.hybrid and self.num_heads == 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def has_attention(self) -> bool:
        return self.num_heads > 0

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def resolved_ssm_heads(self) -> int:
        if not self.has_ssm:
            return 0
        if self.ssm_heads:
            return self.ssm_heads
        return self.d_inner // self.ssm_head_dim

    @property
    def supports_long_context(self) -> bool:
        """True iff decode memory is O(1) in context length (SSM state and/or
        sliding-window KV) — required for the long_500k shape."""
        if self.is_ssm:
            return True
        if self.has_ssm and (self.attn_window > 0 or not self.has_attention):
            return True
        return False

    def moe_layer_mask(self) -> Tuple[bool, ...]:
        """Which layers are MoE layers."""
        if not self.is_moe:
            return tuple(False for _ in range(self.num_layers))
        return tuple(
            (i % self.moe_layer_period) == (self.moe_layer_period - 1)
            for i in range(self.num_layers)
        )

    def num_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        n_q = self.num_heads * hd
        n_kv = self.num_kv_heads * hd
        total = v * d                      # embedding
        if not self.tie_embeddings:
            total += v * d                 # LM head
        total += d                         # final norm
        mask = self.moe_layer_mask()
        for i in range(self.num_layers):
            blk = 2 * d                    # two RMSNorm scales
            if self.has_attention:
                blk += d * (n_q + 2 * n_kv) + n_q * d      # qkv + o
                if self.qkv_bias:
                    blk += n_q + 2 * n_kv
            if self.has_ssm:
                di = self.d_inner
                nh = self.resolved_ssm_heads
                g = self.ssm_groups
                blk += d * (2 * di + 2 * g * self.ssm_state + nh)   # in_proj(x,z,B,C,dt)
                blk += (di + 2 * g * self.ssm_state) * self.ssm_conv_width  # conv(x,B,C)
                blk += 2 * nh + di                                   # A, D, norm
                blk += di * d                                        # out_proj
            n_mlp_mats = 3 if self.gated_mlp else 2
            if self.is_moe and mask[i]:
                blk += self.num_experts * n_mlp_mats * d * f
                if self.shared_expert:
                    blk += n_mlp_mats * d * f
                blk += d * self.num_experts  # router
            elif f > 0:
                blk += n_mlp_mats * d * f    # MLP
            total += blk
        return total

    def num_active_params(self) -> int:
        """Active (per-token) parameter count — MoE counts top-k experts."""
        if not self.is_moe:
            return self.num_params()
        d, f = self.d_model, self.d_ff
        full = self.num_params()
        mask = self.moe_layer_mask()
        n_moe_layers = sum(mask)
        n_mlp_mats = 3 if self.gated_mlp else 2
        inactive = (
            n_moe_layers
            * (self.num_experts - self.experts_per_token)
            * n_mlp_mats * d * f
        )
        return full - inactive


# ---------------------------------------------------------------------------
# Input-shape configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Parallelism / run configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParallelConfig:
    """How a model is laid out on the mesh.

    Axes: ``pod`` (optional outer DP), ``data`` (DP/FSDP), ``model`` (TP/EP).
    The port's ``Model`` reads ``fsdp`` (the specs: weights split over
    ``data`` and gathered before use), ``tp_reduce_bf16``, ``remat``,
    ``attn_impl``, ``monitor_mode`` and ``monitor_staleness``.
    """

    fsdp: bool = True            # shard params over "data" too (ZeRO-3)
    remat: str = "block"         # "block" | "save_mixer" — checkpoint policy
    attn_impl: str = "blocked"   # "blocked" | "pairs" (causal block skipping)
    tp_reduce_bf16: bool = False # explicit bf16 TP down-proj reductions
    expert_axis: str = "model"   # EP placement for MoE
    seq_shard_decode: bool = True  # shard long decode contexts over "model"
    # PFAIT monitor defaults for training
    monitor_mode: str = "pfait"
    monitor_staleness: int = 2


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    seed: int = 0
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1_000
    microbatch: int = 0          # 0 => no grad accumulation


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    defaults = dict(
        num_layers=2,
        d_model=64,
        vocab_size=256,
    )
    if cfg.num_heads:
        defaults.update(num_heads=4, num_kv_heads=max(1, 4 * cfg.num_kv_heads // max(cfg.num_heads, 1)), head_dim=16)
    if cfg.d_ff:
        defaults.update(d_ff=128)
    if cfg.num_experts:
        defaults.update(num_experts=4, experts_per_token=min(cfg.experts_per_token, 2))
    if cfg.ssm_state:
        defaults.update(ssm_state=8, ssm_head_dim=16)
    if cfg.attn_window:
        defaults.update(attn_window=32)
    if cfg.frontend_dim:
        defaults.update(frontend_dim=32)
    defaults.update(overrides)
    return dataclasses.replace(cfg, **defaults)
