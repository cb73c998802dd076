"""Public wrappers for the port's kernels, and their launch counts.

Mirrors ``src/repro/kernels/ops.py``. Each wrapper launches its CUDA kernel
on a CUDA tensor (or raises) and runs its plain PyTorch version
(``ref.py``) on a CPU tensor; ``wrapper.launches`` counts kernel launches
only.
"""
from repro_torch.kernels.rbf import rbf_kernel_matrix
from repro_torch.kernels.smo_chunk import smo_chunk
from repro_torch.kernels.smo_update import smo_f_update

KERNELS = (rbf_kernel_matrix, smo_f_update, smo_chunk)


def launch_counts() -> dict[str, int]:
    """{kernel name: launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
