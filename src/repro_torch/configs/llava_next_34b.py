"""LLaVA-NeXT-34B [vlm] — LM backbone only; the anyres vision tower is a
STUB: ``input_specs`` provides precomputed patch/text embeddings
[batch, seq, d_model].  [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    frontend="vision_anyres",
    frontend_dim=7168,
    rope_theta=5_000_000.0,
)
