"""Bundled AS-Direct Requests (Toledo, Danezis and Goldberg, PETS 2016,
§4.2): Direct Requests through an anonymity system of u users. The wire
is Direct Requests'; ε = ln(((d/(d−d_a))·(n−1)/(p−1) − d_a/(d−d_a))²
+ u − 1) − ln u, δ = 0 (Security Theorem 2: the Composition Lemma over
Theorem 1)."""

from pirbench.schemes import _composition, direct

kind = direct.kind
servers = direct.servers
requests = direct.requests
per_server = direct.per_server


def privacy(config: dict) -> tuple:
    eps, delta = direct.privacy(config)
    return _composition.compose(eps, int(config["u"])), delta
