"""Device and dtype resolution for every entry point of the port.

The reference (``src/repro/svm/__init__.py``) turns on jax x64 so that the
SVM stack runs in float64; here ``DTYPE`` is that choice, passed explicitly.
An entry point runs on ``cuda`` unless the caller passes ``device="cpu"``:
with no GPU and no explicit CPU request it raises instead of quietly
running on the host.
"""
from __future__ import annotations

import torch

#: the SVM path's dtype (LibSVM parity needs a well-converged f64 dual)
DTYPE = torch.float64


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host")
    return dev
