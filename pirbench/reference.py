"""The plain reference the benchmark holds the program to.

It imports nothing of the program. It works from the store's raw bytes,
which the benchmark draws itself, and it reads the program's outputs (the
queries the servers were sent, the servers' answers, the record bytes a
lookup resolved to, the privacy each client was charged) only to judge
them:

- a lookup's record is row ``i`` of the raw bytes;
- a server's answer to one query mask is the XOR of the records the mask
  selects, and its answer to a list of record ids is those rows (plain
  torch on whatever device the tensors are on);
- the masks of one query XOR to the one-hot vector of its index, and
  each mask bit is set with the scheme's density;
- a lookup's dummy ids are a uniform draw, without repeats, from the
  records other than its index;
- a lookup costs the (ε, δ) of the paper's theorems, which each scheme's
  laws file copies (``pirbench/schemes/<scheme>.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def store_bytes(n: int, record_bytes: int, seed: int) -> np.ndarray:
    """The store's raw bytes, ``[n, record_bytes]`` uint8, from ``seed``
    alone."""
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, 0])
    return rng.integers(0, 256, size=(n, record_bytes), dtype=np.uint8)


def weight_moments(density: float, servers: int, odd: bool
                   ) -> Tuple[float, float]:
    """Mean and variance of the ones a query's masks set in one column:
    Binomial(servers, density) given the column's parity (odd in the
    column asked for, even elsewhere). Summed over the exact pmf."""
    t, d = float(density), int(servers)
    ws = [w for w in range(d + 1) if w % 2 == int(odd)]
    logp = [math.lgamma(d + 1) - math.lgamma(w + 1) - math.lgamma(d - w + 1)
            + w * math.log(t) + (d - w) * math.log1p(-t) for w in ws]
    top = max(logp)
    p = [math.exp(v - top) for v in logp]
    z = sum(p)
    mean = sum(w * q for w, q in zip(ws, p)) / z
    var = sum((w - mean) ** 2 * q for w, q in zip(ws, p)) / z
    return mean, var


def density_z(queries: Mapping[int, int], density: float, n: int,
              ones: float) -> float:
    """How many standard deviations the ones counted in the kept queries'
    masks lie from what the scheme draws; ``queries`` maps a number of
    servers to the queries kept with that many masks. Each query has
    n − 1 even columns and one odd, the columns independent."""
    mean = var = 0.0
    for servers, k in sorted(queries.items()):
        me, ve = weight_moments(density, servers, odd=False)
        mo, vo = weight_moments(density, servers, odd=True)
        mean += k * ((n - 1) * me + mo)
        var += k * ((n - 1) * ve + vo)
    return z_score(ones, mean, var) if queries else math.inf


def dummy_moments(n: int, index: int, k: int) -> Tuple[float, float]:
    """Mean and variance of the sum of ``k`` ids drawn uniformly without
    repeats from [0, n) less ``index``."""
    size = n - 1
    mean = (n * (n - 1) / 2 - index) / size
    var = ((n - 1) * n * (2 * n - 1) / 6 - index * index) / size - mean ** 2
    finite = (size - k) / (size - 1) if size > 1 else 0.0
    return k * mean, k * var * finite


def z_score(got: float, mean: float, var: float) -> float:
    """|got − mean| in standard deviations; a law with no spread allows
    its mean alone."""
    if var <= 0:
        return 0.0 if got == mean else math.inf
    return abs(got - mean) / math.sqrt(var)


def _xor_rows(rows: torch.Tensor) -> torch.Tensor:
    """XOR of the rows of a 2-D integer tensor, by halving."""
    if rows.shape[0] == 0:
        return torch.zeros(rows.shape[1], dtype=rows.dtype, device=rows.device)
    while rows.shape[0] > 1:
        if rows.shape[0] % 2:
            rows = torch.cat([rows[:1] ^ rows[-1:], rows[1:-1]])
        half = rows.shape[0] // 2
        rows = rows[:half] ^ rows[half:]
    return rows[0]


def word_view(raw: torch.Tensor) -> torch.Tensor:
    """``[n, nbytes]`` uint8 -> ``[n, nbytes/8]`` int64 when the width
    allows it (fewer, wider XORs), else the bytes themselves."""
    return raw.view(torch.int64) if raw.shape[1] % 8 == 0 else raw


def server_answers(raw_words: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """``masks [d, n]`` {0,1} -> ``[d, nbytes]`` uint8: each server's
    answer, the XOR of the records its mask selects."""
    out = []
    for m in masks:
        rows = raw_words.index_select(0, torch.nonzero(m).flatten())
        out.append(_xor_rows(rows))
    return torch.stack(out).view(torch.uint8)


def answer_bytes(words: torch.Tensor, nbytes: int) -> torch.Tensor:
    """The program's packed answers ``[..., W]`` int32 (little-endian
    words of the record bytes) -> ``[..., nbytes]`` uint8."""
    as_bytes = words.contiguous().view(torch.uint8)
    return as_bytes[..., :nbytes]


def judge_query(masks: np.ndarray | torch.Tensor, index: int) -> Dict[str, float]:
    """One query's ``[d, n]`` masks: whether they XOR to one-hot(index),
    and the bits they set."""
    m = torch.as_tensor(masks)
    folded = (m.sum(dim=0, dtype=torch.int64) % 2).to(torch.uint8)
    want = torch.zeros_like(folded)
    want[index] = 1
    return {"parity_ok": bool(torch.equal(folded, want)),
            "ones": float(m.sum(dtype=torch.int64)),
            "bits": float(m.numel())}
