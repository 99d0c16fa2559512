"""Layer-selection gain metrics: EAGL, ALPS, HAWQ-v3 and the paper's
baselines (uniform, first-to-last, last-to-first)."""
from repro_torch.core.metrics.alps import AlpsConfig, alps_gains, make_probe
from repro_torch.core.metrics.baselines import (first_to_last_gains,
                                                last_to_first_gains,
                                                uniform_gains)
from repro_torch.core.metrics.eagl import eagl_gains, unit_entropy
from repro_torch.core.metrics.hawq import HawqConfig, hawq_gains

__all__ = ["AlpsConfig", "HawqConfig", "alps_gains", "eagl_gains",
           "first_to_last_gains", "hawq_gains", "last_to_first_gains",
           "make_probe", "uniform_gains", "unit_entropy"]
