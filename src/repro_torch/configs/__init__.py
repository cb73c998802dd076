"""Model configs of the port. Mirrors ``src/repro/configs/__init__.py``."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ModelConfig, ShapeConfig, get_config, list_configs)
