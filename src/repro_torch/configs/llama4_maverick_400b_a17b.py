"""Llama-4 Maverick 400B-A17B [moe] — 128 experts top-1, alternating MoE
layers with an always-on shared expert (early-fusion multimodal backbone;
text path modelled here).  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=128,
    experts_per_token=1,
    moe_layer_period=2,      # alternating dense / MoE
    shared_expert=True,
    rope_theta=500_000.0,
)
