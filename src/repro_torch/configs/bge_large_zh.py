"""bge-large-zh-v1.5 — the paper's primary embedding model (326M BERT-large
style bidirectional encoder, 1024-d fp32 output) [arXiv:2309.07597 C-Pack]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="bge-large-zh-v1.5",
    arch_type="encoder",
    block="attn",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=21128,          # chinese bert vocab
    act="gelu",
    norm="layernorm",
    rope_theta=0.0,            # learned absolute positions
    pool="cls",
    embed_dim=1024,
    source="arXiv:2309.07597 (C-Pack / bge-large-zh-v1.5); paper §5.1.2",
)
