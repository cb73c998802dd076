"""The LM zoo of the port (dense llama-family decoders). Mirrors
``src/repro/models/__init__.py``."""
from repro_torch.models.params import (  # noqa: F401
    ParamDef, count_from_defs, init_params)
from repro_torch.models.transformer import (  # noqa: F401
    Transformer, count_params, init_cache, init_model, model_params_def)
