"""Configurations of the port: ``get_config`` and ``get_smoke_config``.

The counterpart of ``src/repro/configs/__init__.py``: the 10 assigned
architectures (the MoE and dense causal LMs, DimeNet, the four recsys
models) and ColBERTv2, each ``CONFIG`` and test-size ``SMOKE`` equal to
the reference's on every field the port has, and ``get_ja_config``
(JaColBERTv2). An unknown name raises ``KeyError``.
"""
from __future__ import annotations

import importlib

_MODULES = {
    # LM family (5)
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    # GNN (1)
    "dimenet": "repro_torch.configs.dimenet",
    # RecSys (4)
    "wide-deep": "repro_torch.configs.wide_deep",
    "deepfm": "repro_torch.configs.deepfm",
    "fm": "repro_torch.configs.fm",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
    # The paper's own model
    "colbertv2": "repro_torch.configs.colbertv2",
}

ASSIGNED_ARCHS = [
    "kimi-k2-1t-a32b", "moonshot-v1-16b-a3b", "qwen2.5-14b",
    "qwen3-0.6b", "qwen1.5-0.5b",
    "dimenet",
    "wide-deep", "deepfm", "fm", "dlrm-rm2",
]

ALL_ARCHS = ASSIGNED_ARCHS + ["colbertv2"]


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown architecture {arch!r}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE


def get_ja_config():
    """JaColBERTv2 (the paper's Japanese model): ColBERTv2's head over
    its own trunk."""
    return _module("colbertv2").JA_CONFIG
