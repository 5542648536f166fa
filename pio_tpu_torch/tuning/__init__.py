"""pio_tpu_torch.tuning — device-parallel evaluation & hyperparameter sweeps.

Counterpart of ``pio_tpu.tuning``, the third DASE pillar: deterministic
splits (``splits``, copied), vectorized ranking metrics with scalar
oracles (``metrics``, rewritten in torch), the batched sweep runner
(``sweep``, its JAX parts rewritten in torch), durable fold/best-params
records (``records``, copied), and the sweep's observability surface
(``server``, copied). Entry points: ``python -m pio_tpu_torch eval
--sweep`` -> ``workflow.evaluate.run_sweep_evaluation``.
"""

from pio_tpu_torch.tuning.metrics import (  # noqa: F401
    AUC,
    MAPAtK,
    NDCGAtK,
    PrecisionAtK,
    RankingMetric,
    RecallAtK,
    parse_metric,
)
from pio_tpu_torch.tuning.records import (  # noqa: F401
    load_best_params,
    resolve_from_eval,
    save_best_params,
)
from pio_tpu_torch.tuning.splits import (  # noqa: F401
    EvalFold,
    folds_for,
    seeded_kfold,
    time_rolling_folds,
)
from pio_tpu_torch.tuning.sweep import (  # noqa: F401
    SweepConfig,
    SweepRunner,
    group_candidates,
)
