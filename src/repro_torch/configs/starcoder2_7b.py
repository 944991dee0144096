"""starcoder2-7b — dense GQA LM with RoPE + 4k sliding window [arXiv:2402.19173].

The real StarCoder2 uses a 4096-token sliding window, which is what makes the
long_500k decode shape runnable for this arch (ring-buffer KV cache)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    arch_type="dense",
    block="attn",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    sliding_window=4096,
    act="gelu",
    norm="layernorm",
    source="arXiv:2402.19173 (StarCoder 2 and The Stack v2)",
)
