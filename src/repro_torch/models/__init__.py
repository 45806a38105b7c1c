"""Models of the port that call attention: the transformer LM, dense or
with the MoE block of :mod:`.moe` (prefill + decode), and BERT4Rec, on the
layers of :mod:`.layers`."""

from repro_torch.models import layers, moe, recsys, transformer

__all__ = ["layers", "moe", "recsys", "transformer"]
