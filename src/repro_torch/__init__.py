"""PyTorch/CUDA port of the alpha-seeded SVM k-fold CV system.

Mirrors ``src/repro/`` module for module where a counterpart exists; each
module names the reference file it mirrors. The port imports torch and
numpy, never jax or ``repro``. The SVM path is float64. Entry points run on
``cuda`` unless the caller passes ``device="cpu"`` (see ``device.py``).
"""
