"""Architecture registry of the port: ``get_arch(arch_id)`` -> the config
module (``CONFIG``, ``SHAPES``, ``reduced()``) of every arch of the
reference package: the LM family, the GNN, the recommenders and the
paper's own workload (``pir-ct``). An unknown arch raises ``KeyError``."""

from __future__ import annotations

import importlib
from typing import Tuple

__all__ = ["ARCHS", "get_arch", "list_archs"]

ARCHS = {
    # LM family
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    # GNN
    "gcn-cora": "repro_torch.configs.gcn_cora",
    # RecSys
    "dien": "repro_torch.configs.dien",
    "fm": "repro_torch.configs.fm",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
    "bert4rec": "repro_torch.configs.bert4rec",
    # the paper's own workload
    "pir-ct": "repro_torch.configs.pir_ct",
}


def get_arch(arch_id: str):
    """Returns the arch module (CONFIG, SHAPES, reduced())."""
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch_id])


def list_archs() -> Tuple[str, ...]:
    return tuple(ARCHS)
