"""AS-Sparse-PIR (Toledo, Danezis and Goldberg, PETS 2016, §4.4):
Sparse-PIR's masks through an anonymity system of u users. The wire is
Sparse-PIR's; ε is the Composition Lemma over Security Theorem 3,
ln(((1+x)/(1−x))⁴ + u − 1) − ln u with x = (1−2θ)^(d−d_a), δ = 0
(Security Theorem 4)."""

from pirbench.schemes import _composition, sparse

kind = sparse.kind
servers = sparse.servers
density = sparse.density


def privacy(config: dict) -> tuple:
    eps, delta = sparse.privacy(config)
    return _composition.compose(eps, int(config["u"])), delta
