from repro_torch.serving.engine import ServingEngine, Request, pad_cache  # noqa: F401
