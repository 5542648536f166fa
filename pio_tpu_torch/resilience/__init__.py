"""Resilience: the deterministic fault-injection (chaos) harness.

Counterpart of ``pio_tpu.resilience``, of which the port has only
``chaos`` so far (a verbatim copy: the spec grammar, the ``PIO_TPU_CHAOS``
environment variable and the ``train.step.<n>`` / ``train.checkpoint`` /
``train.persist`` points of the training lifecycle). The retry and
circuit-breaker policies, ``ResilientDAO``, tenant quotas and the spill
queue are not ported yet.
"""

from pio_tpu_torch.resilience import chaos

__all__ = ["chaos"]
