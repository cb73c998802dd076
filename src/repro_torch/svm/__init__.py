"""SVM substrate of the port: kernels, the SMO engine and its sources, the
lane pool, the helpers.

Mirrors ``src/repro/svm/__init__.py``. The reference turns on jax x64
here; the port passes ``torch.float64`` explicitly (``repro_torch.device``).
"""
from repro_torch.svm.engine import (  # noqa: F401
    DenseKernel, EngineState, FusedRBF, OnDemandRBF, PallasRBF)
from repro_torch.svm.sources import KernelSpec, SourceCache  # noqa: F401
from repro_torch.svm.shrink import (  # noqa: F401
    LaneShrink, bucket_cap, possible_caps, seed_active_mask, solve_shrunk)
from repro_torch.svm.scheduler import (  # noqa: F401
    LanePool, LaneScheduler)
from repro_torch.svm.kernels import (  # noqa: F401
    kernel_matrix, linear_kernel, rbf_kernel)
from repro_torch.svm.smo import (  # noqa: F401
    SMOResult, dual_objective, init_f, smo_solve, smo_solve_batched)
from repro_torch.svm.svc import (  # noqa: F401
    SVC, accuracy, bias_from_solution, decision_function, predict)
