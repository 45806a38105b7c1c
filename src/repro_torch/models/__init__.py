"""Models of the port: the transformer LM, dense or with the MoE block of
:mod:`.moe` (prefill + decode), the recommenders FM, DLRM, DIEN and
BERT4Rec (:mod:`.recsys`) and the GCN (:mod:`.gnn`), on the layers of
:mod:`.layers`."""

from repro_torch.models import gnn, layers, moe, recsys, transformer

__all__ = ["gnn", "layers", "moe", "recsys", "transformer"]
