"""Architecture configs of the port.  Only olmo-1b (``configs.olmo_1b``)
is ported so far; the rest of ``repro.configs`` follows with ROADMAP
Queue 1 item 13."""
from repro_torch.configs.base import ArchConfig, BlockDef

__all__ = ["ArchConfig", "BlockDef"]
