"""Layer-selection gain metrics: EAGL and ALPS.  HAWQ (its Hutchinson
products need a twice-differentiable LSQ backward) and the baselines wait
for a later slice (ROADMAP Queue 1 items 3 and 8)."""
from repro_torch.core.metrics.alps import AlpsConfig, alps_gains, make_probe
from repro_torch.core.metrics.eagl import eagl_gains, unit_entropy

__all__ = ["AlpsConfig", "alps_gains", "eagl_gains", "make_probe",
           "unit_entropy"]
