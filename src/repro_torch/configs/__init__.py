from repro_torch.configs.base import ARCH_MODULES, ModelConfig, get_config

__all__ = ["ARCH_MODULES", "ModelConfig", "get_config"]
