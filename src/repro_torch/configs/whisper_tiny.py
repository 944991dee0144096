"""whisper-tiny — encoder-decoder ASR backbone; mel+conv frontend STUBBED
(the caller provides precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    arch_type="audio",
    block="attn",
    num_layers=4,             # decoder layers
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    cross_attention=True,
    frontend="audio",
    num_frames=1500,
    act="gelu",
    norm="layernorm",
    rope_theta=0.0,           # whisper uses learned positions, not RoPE
    source="arXiv:2212.04356 (Robust Speech Recognition via Large-Scale Weak Supervision)",
)
