"""Configurations of the port: ``get_config`` and ``get_smoke_config``.

The counterpart of ``src/repro/configs/__init__.py`` for the
architectures the port runs: the dense causal Qwen trunks and ColBERTv2.
The reference's other architectures (the MoE LMs, DimeNet, the recsys
models) are not ported and raise ``NotImplementedError``.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "colbertv2": "repro_torch.configs.colbertv2",
}

NOT_PORTED = {
    "kimi-k2-1t-a32b": "MoE (models/moe.py)",
    "moonshot-v1-16b-a3b": "MoE (models/moe.py)",
    "dimenet": "GNN (models/gnn)",
    "wide-deep": "recsys (models/recsys)",
    "deepfm": "recsys (models/recsys)",
    "fm": "recsys (models/recsys)",
    "dlrm-rm2": "recsys (models/recsys)",
}

PORTED_ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch}: the {NOT_PORTED[arch]} family is not ported yet "
            f"(ROADMAP queue 1)")
    if arch not in _MODULES:
        raise KeyError(f"unknown architecture {arch!r}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE
