from repro_torch.configs.base import (LM_SHAPES, MLAConfig, MoEConfig, ModelConfig,
                                ShapeConfig, SSMConfig, FrontendConfig,
                                active_params, count_params, shape_by_name)
from repro_torch.configs.registry import (ARCH_IDS, SUBQUADRATIC, get_config,
                                    get_smoke_config, shape_applicable)

__all__ = [
    "LM_SHAPES", "MLAConfig", "MoEConfig", "ModelConfig", "ShapeConfig",
    "SSMConfig", "FrontendConfig", "active_params", "count_params",
    "shape_by_name", "ARCH_IDS", "SUBQUADRATIC", "get_config",
    "get_smoke_config", "shape_applicable",
]
