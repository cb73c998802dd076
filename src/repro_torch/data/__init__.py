"""Datasets of the port. Mirrors ``src/repro/data/__init__.py`` (the
token streams of the LM zoo are a later slice)."""
from repro_torch.data.svm_suite import (  # noqa: F401
    DATASETS, SPECS, SVMDataset, kfold_chunks, make_dataset)
