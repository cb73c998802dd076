"""Deterministic synthetic LM token batches: the port's own copy of
``src/repro/data/tokens.py::synthetic_token_batch`` (plain numpy; the port
imports nothing of ``repro``). ``tests/test_torch_data.py`` holds it to the
original bit for bit.

Batch ``step`` is a pure function of (seed, step), so a restarted run
regenerates the exact stream from the step index.
"""
from __future__ import annotations

import numpy as np


def synthetic_token_batch(vocab_size: int, batch: int, seq_len: int,
                          *, seed: int = 0, step: int = 0) -> dict:
    """Returns {tokens, targets, mask}: a Zipf-ish token stream with a simple
    learnable bigram structure."""
    rng = np.random.default_rng((seed * 1_000_003 + step) % (2**63))
    # Zipf-distributed unigrams, clipped to vocab
    base = rng.zipf(1.3, size=(batch, seq_len)).astype(np.int64)
    tokens = base % vocab_size
    # inject bigram structure: even positions predict (t*7+3) % V at odd ones
    tokens[:, 1::2] = (tokens[:, 0::2] * 7 + 3) % vocab_size
    targets = np.roll(tokens, -1, axis=1)
    mask = np.ones((batch, seq_len), np.float32)
    mask[:, -1] = 0.0
    return {"tokens": tokens, "targets": targets, "mask": mask}
