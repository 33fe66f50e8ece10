from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    ShapeConfig,
    SHAPES,
    assigned_archs,
    get_config,
    list_configs,
    register,
    shape_applicable,
)
