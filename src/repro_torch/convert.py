"""Carry state from the JAX reference into the port.

The reference hands its results over as numpy arrays (``np.asarray`` of
each field), so this module needs neither jax nor ``repro``. The tests use
it to start the port from the reference's exact state (for example fold
h's solution) and so check a seeder or a solve in isolation, and to build
the port's kernel sources and plan lanes from the reference's operands,
and to load the reference's LM parameters and KV caches into the port's
layer-by-layer trees.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.study import LaneSpec
from repro_torch.data.svm_suite import SVMDataset
from repro_torch.device import DTYPE, resolve_device
from repro_torch.models.params import leaf_dtype
from repro_torch.models.transformer import cache_def, layer_plan
from repro_torch.svm.engine import DenseKernel, PallasRBF, SMOResult


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


def source_from_reference(*, K=None, X=None, sq_norms=None, gamma=None,
                          device=None):
    """The port's ``DenseKernel`` from the reference's K, or its
    ``PallasRBF`` from the reference's X, row norms and gamma; arrays as
    numpy, copied to ``device`` in float64."""
    dev = resolve_device(device)
    if (K is None) == (X is None):
        raise ValueError("give K (a dense source) or X (a PallasRBF)")
    if K is not None:
        return DenseKernel(torch.as_tensor(np.array(K), dtype=DTYPE,
                                           device=dev))
    Xt = torch.as_tensor(np.array(X), dtype=DTYPE, device=dev)
    sq = None if sq_norms is None else torch.as_tensor(
        np.array(sq_norms), dtype=DTYPE, device=dev)
    return PallasRBF(Xt, float(gamma), sq)


def lane_from_reference(spec, device=None) -> LaneSpec:
    """The port's ``LaneSpec`` of a start lane from any object with the
    reference's ``LaneSpec`` fields (``id``, ``source``, ``train_mask``,
    ``C``, ``alpha0``, ``f0``, ``n_iter0``, ``max_iter``, ``after``);
    arrays as numpy, copied to ``device``."""
    dev = resolve_device(device)

    def t(a, dtype):
        return None if a is None else torch.as_tensor(np.array(a),
                                                      dtype=dtype, device=dev)

    return LaneSpec(id=spec.id, source=spec.source,
                    train_mask=t(spec.train_mask, torch.bool),
                    C=None if spec.C is None else float(spec.C),
                    alpha0=t(spec.alpha0, DTYPE), f0=t(spec.f0, DTYPE),
                    n_iter0=int(spec.n_iter0), max_iter=int(spec.max_iter),
                    after=spec.after)


def _host_tensor(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 ones too, which torch cannot take from
    numpy: widened to float32, exactly) as a tensor on ``device``."""
    a = np.array(a)
    return torch.as_tensor(a.astype(np.float32) if a.dtype.name == "bfloat16"
                           else a, device=device)


def _tree(x, to_tensor, i=None):
    """A nested dict of arrays as one of tensors (each leaf's index ``i``
    of its leading axis, where given)."""
    if isinstance(x, dict):
        return {k: _tree(v, to_tensor, i) for k, v in x.items()}
    return to_tensor(x if i is None else np.asarray(x)[i])


def _unstack(stages, cfg, to_tensor) -> list:
    """The reference's scanned stages (``transformer.py::_stack_defs``: a
    stage repeated r times holds each leaf with a leading (r, ...) axis)
    as one subtree per layer, in layer order: a deepseek-v2's repeated
    [MLA + MoE] stage of 59 layers (3 at SMOKE size) becomes 59 subtrees,
    the MoE's router and shared experts nested in each; Jamba's plan mixes
    a scanned pair, repeated twice, with single layers (8 layers) or is
    one scanned period of 8 (16 layers), each pattern walked layer by layer
    within each repeat."""
    layers = []
    for (pattern, repeat), stage in zip(layer_plan(cfg), stages,
                                        strict=True):
        for i in range(repeat):
            for li in range(len(pattern)):
                layers.append(_tree(stage[li], to_tensor,
                                    i if repeat > 1 else None))
    return layers


def model_params_from_reference(params_np, cfg, device=None,
                                dtype=torch.float32) -> dict:
    """The port's parameter tree (``Transformer``'s input) from the
    reference's, given as nested dicts and lists of numpy arrays. Every
    weight keeps the reference's layout (``wq`` (D, H, Dh), ``wo``
    (H, Dh, D), MLP weights (in, out), MLA's and the experts' as the
    reference has them; mamba's ``in_proj`` (D, 2 Din), ``conv_w`` (Cv,
    Din), ``x_db`` (Din, dt_rank + 2 St), ``dt_proj_w`` (dt_rank, Din),
    ``A_log`` (Din, St), ``out_proj`` (Din, D)); the stages are unstacked,
    and DeepSeek-V3's ``mtp`` subtree is carried as it is."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), device=dev).to(dtype)
    out = {"embed": {"table": t(params_np["embed"]["table"])},
           "final_norm": {"scale": t(params_np["final_norm"]["scale"])},
           "layers": _unstack(params_np["stages"], cfg, t)}
    if "lm_head" in params_np:
        out["lm_head"] = {"table": t(params_np["lm_head"]["table"])}
    if "mtp" in params_np:
        out["mtp"] = _tree(params_np["mtp"], t)
    return out


def cache_from_reference(cache_np, cfg, device=None,
                         dtype=torch.float32) -> dict:
    """The port's cache (``{"layers": [{"k", "v"} or, for MLA, {"c",
    "kr"} or, for mamba, {"conv", "ssm"}, ...]}``) from the reference's
    ``init_cache`` tree of numpy arrays, in ``dtype`` but for the leaves
    the reference holds in a dtype of their own (mamba's float32
    ``ssm``)."""
    dev = resolve_device(device)
    layers = _unstack(cache_np["stages"], cfg,
                      lambda a: _host_tensor(a, dev))
    defs = cache_def(cfg, 1, 1)["layers"]
    return {"layers": [{k: t.to(leaf_dtype(d[k], dtype))
                        for k, t in layer.items()}
                       for layer, d in zip(layers, defs, strict=True)]}
