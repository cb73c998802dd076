"""Parameter definitions: one tree of ``ParamDef`` (shape + logical axes +
initializer) per model, from which ``init_params`` draws real tensors and
``count_from_defs`` counts without allocating. Mirrors
``src/repro/models/params.py``; a tree is nested dicts and lists.

The init rules are the reference's: ``normal`` (stddev ``scale``, or
``1/sqrt(shape[-2])`` when ``scale`` is None), ``zeros``, ``ones``; a
leaf's ``dtype`` (a torch dtype's name, e.g. mamba's float32 ``ssm``
state in a bf16 cache) overrides the tree's. The
draws come from an explicit ``torch.Generator`` on the target device, so
their values differ from ``jax.random``'s: parity with the reference goes
through ``repro_torch.convert.model_params_from_reference``.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple              # logical axis names, len == len(shape)
    init: str = "normal"     # normal | zeros | ones
    scale: float | None = None  # stddev; default fan-in scaling
    dtype: str | None = None    # per-leaf override (e.g. f32 SSM states)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in length")


def map_defs(fn, tree):
    """``tree`` with every ``ParamDef`` leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, ParamDef):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_defs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_defs(fn, v) for v in tree]
    raise TypeError(f"not a ParamDef tree node: {type(tree).__name__}")


def leaves(tree) -> list:
    """The ``ParamDef`` (or tensor) leaves of ``tree``, in tree order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def leaf_dtype(d: ParamDef, dtype: torch.dtype) -> torch.dtype:
    """The dtype a leaf is held in: its own where it names one, else
    ``dtype``."""
    return getattr(torch, d.dtype) if d.dtype else dtype


def init_params(defs, generator: torch.Generator, dtype=torch.float32,
                device=None):
    """Real tensors for a ``ParamDef`` tree, drawn leaf by leaf in tree
    order from ``generator`` (which must live on ``device``): normal draws
    in float32, scaled, then cast to ``dtype`` (or the leaf's own)."""
    device = generator.device if device is None else torch.device(device)

    def draw(d: ParamDef):
        dt = leaf_dtype(d, dtype)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        if d.init != "normal":
            raise ValueError(f"unknown init {d.init!r}")
        scale = d.scale
        if scale is None:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(scale).to(dt)
    return map_defs(draw, defs)


def count_from_defs(defs) -> int:
    return int(sum(math.prod(d.shape) for d in leaves(defs)))
