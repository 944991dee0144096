from repro_torch.configs.base import (ARCH_MODULES, ASSIGNED_ARCHS,
                                     INPUT_SHAPES, ModelConfig, ShapeConfig,
                                     get_config, get_shape, shape_supported)

__all__ = ["ARCH_MODULES", "ASSIGNED_ARCHS", "INPUT_SHAPES", "ModelConfig",
           "ShapeConfig", "get_config", "get_shape", "shape_supported"]
