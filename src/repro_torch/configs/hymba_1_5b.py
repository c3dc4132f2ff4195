"""Hymba-1.5B [hybrid] — parallel attention + mamba heads inside each block,
sliding-window attention (constant-memory decode).  [arXiv:2411.13676; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid=True,
    attn_window=2048,     # sliding window => O(1) decode memory
    rope_theta=10_000.0,
)
