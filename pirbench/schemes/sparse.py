"""Sparse-PIR (Toledo, Danezis and Goldberg, PETS 2016, §4.3): each mask
bit set with probability θ, the d masks XOR-ing to the index.
ε = 4·artanh((1−2θ)^(d−d_a)), δ = 0 (Security Theorem 3)."""

import math

from pirbench.schemes import check_servers

kind = "mask"


def privacy(config: dict) -> tuple:
    d, d_a = check_servers(config)
    x = (1.0 - 2.0 * float(config["theta"])) ** (d - d_a)
    return (math.inf if x >= 1.0 else 4.0 * math.atanh(x)), 0.0


def servers(config: dict) -> int:
    return int(config["d"])


def density(config: dict) -> float:
    return float(config["theta"])
