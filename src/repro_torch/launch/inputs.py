"""Concrete input batches for the port's dense LMs. Mirrors
``src/repro/launch/inputs.py::concrete_batch`` for token-only configs
(enc-dec frames, vision patches and M-RoPE positions wait with their
architectures, ROADMAP.md Queue 1 item 12)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.tokens import synthetic_token_batch
from repro_torch.device import resolve_device


def concrete_batch(cfg: ModelConfig, batch: int, seq: int, seed=0,
                   device=None) -> dict:
    """{tokens, targets (int64), mask (float32)} of shape (batch, seq) on
    ``device``, from ``synthetic_token_batch``."""
    if cfg.is_encoder_decoder or cfg.frontend or cfg.rope_kind == "mrope":
        raise NotImplementedError(
            f"{cfg.name}: only token inputs are ported (ROADMAP.md, Queue 1 "
            "item 12)")
    dev = resolve_device(device)
    b = synthetic_token_batch(cfg.vocab_size, batch, seq, seed=seed)
    return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
