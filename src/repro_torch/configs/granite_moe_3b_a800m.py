"""granite-moe-3b-a800m — IBM Granite 3.0 MoE, 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    block="attn",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,                 # per-expert hidden
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (Granite 3.0 MoE family)",
)
