"""Models of the port that call attention: the dense transformer LM
(prefill + decode) and BERT4Rec, on the layers of :mod:`.layers`."""

from repro_torch.models import layers, recsys, transformer

__all__ = ["layers", "recsys", "transformer"]
