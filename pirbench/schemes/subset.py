"""Subset-PIR (Toledo, Danezis and Goldberg, PETS 2016, §5.1): Chor's
scheme among t of the d servers. ε = 0, δ = Π_{i<t} (d_a−i)/(d−i), the
chance that all t are corrupt; 0 once t > d_a (Security Theorem 5)."""

from pirbench.schemes import check_servers

kind = "mask"


def privacy(config: dict) -> tuple:
    d, d_a = check_servers(config)
    t = servers(config)
    delta = 1.0
    for i in range(t):
        delta *= max(d_a - i, 0) / (d - i)
    return 0.0, delta


def servers(config: dict) -> int:
    t = int(config["t"])
    if not 2 <= t <= int(config["d"]):
        raise ValueError(f"subset needs 2 <= t <= d, got t={t}")
    return t


def density(config: dict) -> float:
    return 0.5
