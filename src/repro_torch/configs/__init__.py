"""Architecture registry of the port: ``get_config(name)`` (port of
``repro/configs/__init__.py``).

olmo-1b and the paper's bert-base are ported; every other name of the
reference's registry raises ``NotImplementedError`` naming ROADMAP Queue 1
item 13, which ports the rest of the zoo.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, BlockDef

_MODULES = {
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "bert-base": "repro_torch.configs.bert_base",
}
# the reference's other architectures, not ported yet
_PENDING = ("deepseek-7b", "internlm2-1.8b", "granite-20b", "qwen2-vl-7b",
            "deepseek-v3-671b", "dbrx-132b", "jamba-1.5-large-398b",
            "xlstm-1.3b", "hubert-xlarge")


def get_config(name: str) -> ArchConfig:
    if name in _PENDING:
        raise NotImplementedError(f"{name} is not ported yet (ROADMAP "
                                  f"Queue 1 item 13); ported: "
                                  f"{sorted(_MODULES)}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).config()


__all__ = ["ArchConfig", "BlockDef", "get_config"]
