"""SVM substrate of the port: kernels, the dense SMO engine, the helpers.

Mirrors ``src/repro/svm/__init__.py``. The reference turns on jax x64
here; the port passes ``torch.float64`` explicitly (``repro_torch.device``).
"""
from repro_torch.svm.engine import DenseKernel, EngineState  # noqa: F401
from repro_torch.svm.kernels import (  # noqa: F401
    kernel_matrix, linear_kernel, rbf_kernel)
from repro_torch.svm.smo import (  # noqa: F401
    SMOResult, dual_objective, init_f, smo_solve)
from repro_torch.svm.svc import (  # noqa: F401
    accuracy, bias_from_solution, decision_function, predict)
