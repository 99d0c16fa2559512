"""Architecture registry of the port: ``get_config(name)`` (port of
``repro/configs/__init__.py``).

The dense architectures are ported: olmo-1b, internlm2-1.8b, deepseek-7b,
granite-20b, the paper's bert-base and hubert-xlarge; dbrx-132b's
mixture of experts; qwen2-vl-7b's M-RoPE; and deepseek-v3-671b's MLA,
dense prefix blocks, shared expert and multi-token head.  The reference's
other names (the SSMs) raise ``NotImplementedError`` naming ROADMAP
Queue 1 item 13.4, which ports them.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, BlockDef

_MODULES = {
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "bert-base": "repro_torch.configs.bert_base",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
}
# the reference's other architectures, not ported yet, and the ROADMAP
# Queue 1 item that ports each
_PENDING = {"jamba-1.5-large-398b": "13.4 (the SSMs)",
            "xlstm-1.3b": "13.4 (the SSMs)"}


def get_config(name: str) -> ArchConfig:
    if name in _PENDING:
        raise NotImplementedError(f"{name} is not ported yet (ROADMAP "
                                  f"Queue 1 item {_PENDING[name]}); "
                                  f"ported: {sorted(_MODULES)}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).config()


__all__ = ["ArchConfig", "BlockDef", "get_config"]
