"""Serving-side admission and batching (single-host dispatch shaping).

The device-facing serving logic lives in ``workflow/serve.py`` (the
QueryServer); this package holds the pieces that sit BETWEEN the HTTP
edge and the device program — the cross-request continuous batcher."""

from pio_tpu_torch.serving.batcher import ContinuousBatcher

__all__ = ["ContinuousBatcher"]
