"""Layer-selection gain metrics.  EAGL is ported; ALPS, HAWQ and the
baselines wait for a later slice (ROADMAP Queue 1 item 8)."""
from repro_torch.core.metrics.eagl import eagl_gains, unit_entropy

__all__ = ["eagl_gains", "unit_entropy"]
