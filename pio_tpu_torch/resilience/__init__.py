"""Resilience: the deterministic fault-injection (chaos) harness and the
call policies the fold-in worker runs under.

Counterpart of ``pio_tpu.resilience``, of which the port has ``chaos``
(a verbatim copy: the spec grammar, the ``PIO_TPU_CHAOS`` environment
variable and the ``train.step.<n>`` / ``train.checkpoint`` /
``train.persist`` / ``foldin.solve`` / ``foldin.apply`` points) and
``policies`` (a verbatim copy: retry, circuit breaker, deadline). The
``ResilientDAO``, health checks, tenant quotas and the spill queue are
not ported yet.
"""

from pio_tpu_torch.resilience import chaos
from pio_tpu_torch.resilience.policies import (
    CircuitBreaker,
    CircuitOpenError,
    Deadline,
    DeadlineExceeded,
)

__all__ = [
    "CircuitBreaker",
    "CircuitOpenError",
    "Deadline",
    "DeadlineExceeded",
    "chaos",
]
