"""Hand-written Hopper kernels of the port (``csrc/``), their ctypes
wrappers and their plain PyTorch versions (``ref.py``).

Mirrors ``src/repro/kernels/`` (the Pallas TPU kernels)."""
