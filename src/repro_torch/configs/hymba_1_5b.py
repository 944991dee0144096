"""hymba-1.5b — hybrid-head (parallel attention + mamba) LM [arXiv:2411.13676]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    block="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    # Hymba uses sliding-window attention in most layers; the SWA+SSM combo is
    # what makes it sub-quadratic and long_500k-capable.
    sliding_window=1024,
    source="arXiv:2411.13676 (Hymba: A Hybrid-head Architecture for Small LMs)",
)
