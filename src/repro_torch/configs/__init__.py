"""Architecture registry of the port: ``get_arch(arch_id)`` -> the config
module (``CONFIG``, ``SHAPES``, ``reduced()``) of the archs ported so far:
the paper's own workload (``pir-ct``), the LM family (the dense
``smollm-135m``, ``gemma2-2b`` and ``mistral-nemo-12b``, the MoE
``moonshot-v1-16b-a3b`` and ``kimi-k2-1t-a32b``) and the recommender
``bert4rec``. The reference package's other archs are listed in
ROADMAP.md Queue A item 13; asking for one raises ``KeyError``."""

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
    # RecSys
    "bert4rec": "repro_torch.configs.bert4rec",
    # the paper's own workload
    "pir-ct": "repro_torch.configs.pir_ct",
}

# archs of the reference package this port does not have yet
_NOT_PORTED = ("gcn-cora", "dien", "fm", "dlrm-rm2")


def get_arch(arch_id: str):
    """Returns the arch module (CONFIG, SHAPES, reduced())."""
    if arch_id in _NOT_PORTED:
        raise KeyError(
            f"arch {arch_id!r} is not ported yet (ROADMAP.md Queue A item "
            f"13); ported: {sorted(ARCHS)}"
        )
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(ARCHS[arch_id])


def list_archs() -> Tuple[str, ...]:
    return tuple(ARCHS)
