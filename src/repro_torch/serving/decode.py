"""Serving runtime: prefill, and batched one-token decode against the KV
cache. Mirrors ``src/repro/serving/decode.py``.

serve_step = embed -> the layers (each writes its k and v into the cache in
place) -> logits -> greedy or sampled next token.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import decode_step, forward


def build_serve_step(cfg, sample: str = "greedy"):
    """``serve_step(model, cache, batch) -> (next tokens (B,), cache)``.

    ``sample="greedy"`` takes the argmax of the last position's float32
    logits. Any other value samples from their softmax with a
    ``torch.Generator`` on the model's device seeded by ``step``: the same
    step gives the same draw, but not ``jax.random``'s draw, so sampled
    tokens cannot match the reference's.
    """
    def serve_step(model, cache, batch):
        if model.cfg != cfg:
            raise ValueError("serve_step built for another config")
        logits, cache = decode_step(model, cache, batch)
        last = logits[:, -1].float()
        if sample == "greedy":
            return torch.argmax(last, dim=-1), cache
        gen = torch.Generator(device=last.device)
        gen.manual_seed(int(batch["step"]))
        nxt = torch.multinomial(torch.softmax(last, -1), 1, generator=gen)
        return nxt[:, 0], cache
    return serve_step


def prefill_logits(model, batch):
    """Inference prefill: full-context forward, logits for the LAST position
    only (B, 1, V)."""
    logits, _ = forward(model, batch, mode="prefill")
    return logits
