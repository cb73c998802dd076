"""The paper's contribution: alpha-seeded SVM k-fold cross-validation.

Mirrors ``src/repro/core/__init__.py`` for the slice ported so far.
"""
from repro_torch.core.cv import CVReport, FoldStat, run_cv  # noqa: F401
from repro_torch.core.seeding import (  # noqa: F401
    SEEDERS, ato_seed, cold_seed, mir_seed, repair_equality, sir_seed,
    water_fill)
