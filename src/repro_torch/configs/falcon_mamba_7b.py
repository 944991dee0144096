"""falcon-mamba-7b — attention-free Mamba-1 LM [arXiv:2410.05355]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    block="mamba",
    num_layers=64,
    d_model=4096,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_expand=2,
    source="arXiv:2410.05355 (Falcon Mamba: The First Competitive Attention-free 7B)",
)
