"""Serving plane of the port.

- :mod:`imagekit_tpu_torch.serving.app`         — routes, handlers, middleware
  (the reference's HTTP contract, on the port's engine);
- :mod:`imagekit_tpu_torch.serving.batcher`     — the batched engine core;
- :mod:`imagekit_tpu_torch.serving.engine_jpeg` — the JPEG -> WebP head;
- :mod:`imagekit_tpu_torch.serving.engine`      — the engine interface.

Metrics and rate limiting are the reference's own
(:mod:`imagekit_tpu.serving.metrics`, :mod:`imagekit_tpu.serving.ratelimit`).
"""
