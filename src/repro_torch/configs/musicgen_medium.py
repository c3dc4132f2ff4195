"""MusicGen-medium [audio] — decoder-only transformer over EnCodec tokens.
The EnCodec frontend is a STUB: ``input_specs`` provides precomputed frame
embeddings [batch, seq, d_model]; the backbone predicts codebook tokens
(vocab 2048).  [arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,     # MHA
    d_ff=6144,
    gated_mlp=False,     # classic GELU MLP
    vocab_size=2048,
    frontend="audio_codec",
    frontend_dim=1536,
    rope_theta=10_000.0,
)
