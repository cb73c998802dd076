"""Datasets of the port. Mirrors ``src/repro/data/__init__.py``."""
from repro_torch.data.svm_suite import (  # noqa: F401
    DATASETS, SPECS, SVMDataset, kfold_chunks, make_dataset)
from repro_torch.data.tokens import synthetic_token_batch  # noqa: F401
