"""StarCoder2-3B [dense] — GQA kv=2, RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    gated_mlp=False,      # classic GELU MLP
    rope_theta=999_999.4,
)
