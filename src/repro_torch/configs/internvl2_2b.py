"""internvl2-2b — InternViT frontend (stub) + InternLM2-1.8B LM [arXiv:2404.16821]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    arch_type="vlm",
    block="attn",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision",
    num_patches=256,
    rope_theta=1_000_000.0,
    source="arXiv:2404.16821 (InternVL2; InternViT vision stub + InternLM2 backbone)",
)
