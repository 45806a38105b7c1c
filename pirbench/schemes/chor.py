"""Chor, Goldreich, Kushilevitz and Sudan's d-server XOR scheme (FOCS
1995): a uniform mask to each of the d servers, the d masks XOR-ing to
the index. Perfectly private against any d_a < d: ε = δ = 0."""

from pirbench.schemes import check_servers

kind = "mask"


def privacy(config: dict) -> tuple:
    check_servers(config)
    return 0.0, 0.0


def servers(config: dict) -> int:
    return int(config["d"])


def density(config: dict) -> float:
    return 0.5
