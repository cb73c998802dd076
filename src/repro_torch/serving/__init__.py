from repro_torch.serving.decode import build_serve_step, prefill_logits  # noqa: F401
