"""Architecture registry: one config module per assigned architecture
(data only, as in ``repro.configs``)."""
from repro_torch.configs.base import (  # noqa: F401
    LM_SHAPES,
    ModelConfig,
    ShapeSpec,
    applicable_shapes,
    get_config,
    list_archs,
    register,
)
