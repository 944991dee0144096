"""jina-embeddings-v2 — the paper's supplementary embedding model (570M,
8192-token context) [arXiv:2310.19923]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jina-v2",
    arch_type="encoder",
    block="attn",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=61056,
    act="gelu",
    norm="layernorm",
    rope_theta=0.0,            # ALiBi in the real model; stub as learned positions
    pool="mean",
    embed_dim=1024,
    source="arXiv:2310.19923 (Jina Embeddings 2); paper §5.1.2",
)
