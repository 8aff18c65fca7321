"""Architecture registry: ``--arch <id>`` resolution for the launcher,
the counterpart of the JAX package's ``repro.configs``.

``ARCH_IDS`` holds the architectures the port runs, the JAX package's
ten in its order: the five LM ones, the four GNN ones and ``bert4rec``
(recsys); ``ArchSpec.family`` tells them apart.  ``_NOT_PORTED`` names
the ROADMAP item of an architecture the port does not run yet (none
now): ``get_config`` raises a ``KeyError`` naming it.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchSpec, ShapeSpec

_MODULES = {
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b",
    "mace": "repro_torch.configs.mace",
    "nequip": "repro_torch.configs.nequip",
    "gat-cora": "repro_torch.configs.gat_cora",
    "pna": "repro_torch.configs.pna",
    "bert4rec": "repro_torch.configs.bert4rec",
}

# Architectures of the JAX package the port does not run yet, by the
# ROADMAP item that brings them.
_NOT_PORTED: dict[str, str] = {}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ArchSpec:
    if arch_id in _NOT_PORTED:
        raise KeyError(f"{arch_id!r} is not ported yet: ROADMAP.md queue 1, "
                       f"item {_NOT_PORTED[arch_id]}")
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.smoke() if smoke else mod.CONFIG


def all_configs(smoke: bool = False) -> dict[str, ArchSpec]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}


__all__ = ["ArchSpec", "ShapeSpec", "ARCH_IDS", "get_config", "all_configs"]
