"""The Composition Lemma (Toledo, Danezis and Goldberg, PETS 2016, §4.2):
a scheme with ε₁ a lookup, its messages sent through an anonymity system
of u users, costs ε₂ = ln(e^{2ε₁} + u − 1) − ln u, its δ unchanged."""

import math


def compose(eps1: float, u: int) -> float:
    """ε₂, as ln(1 + (e^{2ε₁} − 1)/u): the same number, without losing a
    small ε₁ against ln u."""
    if u < 1:
        raise ValueError(f"need u >= 1, got u={u}")
    if math.isinf(eps1):
        return math.inf
    return math.log1p(math.expm1(2.0 * eps1) / u)
