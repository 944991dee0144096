from repro_torch.configs.base import (ARCH_MODULES, INPUT_SHAPES, ModelConfig,
                                     ShapeConfig, get_config)

__all__ = ["ARCH_MODULES", "INPUT_SHAPES", "ModelConfig", "ShapeConfig",
           "get_config"]
