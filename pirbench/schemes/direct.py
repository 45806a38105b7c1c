"""Direct Requests (Toledo, Danezis and Goldberg, PETS 2016, §4.1): the
index among p − 1 distinct dummies drawn uniformly from the other n − 1
records, p/d ids to each server, which returns the rows asked.
ε = ln((d·(n−1)/(p−1) − d_a)/(d − d_a)), δ = 0 (Security Theorem 1)."""

import math

from pirbench.schemes import check_servers

kind = "index"


def privacy(config: dict) -> tuple:
    d, d_a = check_servers(config)
    n, p = int(config["n_records"]), requests(config)
    ratio = (d * (n - 1) / (p - 1) - d_a) / (d - d_a)
    return math.log(ratio), 0.0


def servers(config: dict) -> int:
    return int(config["d"])


def requests(config: dict) -> int:
    p, d, n = int(config["p"]), int(config["d"]), int(config["n_records"])
    if not 1 < p <= n or p % d:
        raise ValueError(f"direct needs 1 < p <= n and p a multiple of d, "
                         f"got p={p}, d={d}, n={n}")
    return p


def per_server(config: dict) -> int:
    return requests(config) // int(config["d"])
