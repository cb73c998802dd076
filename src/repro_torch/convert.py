"""Carry state from the JAX reference into the port.

The reference hands its results over as numpy arrays (``np.asarray`` of
each field), so this module needs neither jax nor ``repro``. The tests use
it to start the port from the reference's exact state (for example fold
h's solution) and so check a seeder or a solve in isolation.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.svm_suite import SVMDataset
from repro_torch.device import DTYPE, resolve_device
from repro_torch.svm.engine import SMOResult


def result_from_reference(res: dict, device=None) -> SMOResult:
    """The port's ``SMOResult`` from the reference's, given as a dict of
    numpy arrays keyed by field name (``alpha``, ``f``, ``n_iter``,
    ``converged``, ``b_up``, ``b_low``)."""
    dev = resolve_device(device)
    dtypes = {"alpha": DTYPE, "f": DTYPE, "n_iter": torch.int64,
              "converged": torch.bool, "b_up": DTYPE, "b_low": DTYPE}
    return SMOResult(**{k: torch.as_tensor(np.array(res[k]), dtype=dt,
                                           device=dev)
                        for k, dt in dtypes.items()})


def dataset_from_reference(ds) -> SVMDataset:
    """The port's ``SVMDataset`` from any object with the reference's
    fields (``name``, ``X``, ``y``, ``C``, ``gamma``); arrays are copied."""
    return SVMDataset(name=ds.name, X=np.array(ds.X, dtype=np.float64),
                      y=np.array(ds.y, dtype=np.int64), C=float(ds.C),
                      gamma=float(ds.gamma))
