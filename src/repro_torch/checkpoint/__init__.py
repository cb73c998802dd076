"""Crash-consistent checkpoints (mirrors ``src/repro/checkpoint/``)."""
from repro_torch.checkpoint.manager import (CheckpointManager,  # noqa: F401
                                            load_pytree, namespace_path,
                                            save_pytree)
