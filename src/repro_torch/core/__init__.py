"""The paper's contribution: alpha-seeded SVM k-fold cross-validation.

Mirrors ``src/repro/core/__init__.py``.
"""
from repro_torch.core.seeding import (  # noqa: F401
    cold_seed, mir_seed, sir_seed, ato_seed, ato_seed_ref, ato_seed_batch,
    avg_seed_loo, top_seed_loo, water_fill, repair_equality, SEEDERS,
)
from repro_torch.core.study import (  # noqa: F401
    EvalSpec, LaneSpec, LaneStat, Plan, StudyCheckpoint, StudyResult,
    run_plan)
from repro_torch.core.cv import (  # noqa: F401
    run_cv, run_cv_batched, run_loo, CVReport, FoldStat)
from repro_torch.core.grid import (  # noqa: F401
    run_grid, grid_plans, GridCell, GridReport)
