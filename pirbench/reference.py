"""The plain reference the benchmark holds the program to.

It imports nothing of the program. It works from the store's raw bytes,
which the benchmark draws itself, and it reads the program's outputs (the
query masks the servers were sent, the servers' answers, the record bytes
a lookup resolved to, the privacy each client was charged) only to judge
them:

- a lookup's record is row ``i`` of the raw bytes;
- a server's answer to one query mask is the XOR of the records the mask
  selects (plain torch on whatever device the tensors are on);
- the d masks of one query XOR to the one-hot vector of its index, and
  each mask bit is set with the scheme's density (θ for Sparse-PIR, 1/2
  for Chor);
- a lookup costs the (ε, δ) of the paper's theorems, copied here:
  Sparse-PIR ε = 4·artanh((1−2θ)^(d−d_a)), δ = 0 (Toledo, Danezis and
  Goldberg, PETS 2016, Security Theorem 3); Chor ε = δ = 0.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch


def store_bytes(n: int, record_bytes: int, seed: int) -> np.ndarray:
    """The store's raw bytes, ``[n, record_bytes]`` uint8, from ``seed``
    alone."""
    rng = np.random.default_rng([seed & 0xFFFFFFFFFFFFFFFF, 0])
    return rng.integers(0, 256, size=(n, record_bytes), dtype=np.uint8)


def privacy(scheme: str, d: int, d_a: int, theta: float | None
            ) -> Tuple[float, float]:
    """(ε, δ) a lookup of ``scheme`` costs."""
    if not 0 <= d_a < d:
        raise ValueError(f"need 0 <= d_a < d, got d={d}, d_a={d_a}")
    if scheme == "chor":
        return 0.0, 0.0
    if scheme == "sparse":
        x = (1.0 - 2.0 * float(theta)) ** (d - d_a)
        return (math.inf if x >= 1.0 else 4.0 * math.atanh(x)), 0.0
    raise ValueError(f"no reference for scheme {scheme!r}")


def weight_moments(scheme: str, theta: float | None, d: int, odd: bool
                   ) -> Tuple[float, float]:
    """Mean and variance of the ones a query's masks set in one column:
    Binomial(d, θ) given the column's parity (odd in the column asked
    for, even elsewhere). Chor's masks are uniform given the parity:
    θ = 1/2. Summed over the exact pmf."""
    t = 0.5 if scheme == "chor" else float(theta)
    ws = [w for w in range(d + 1) if w % 2 == int(odd)]
    logp = [math.lgamma(d + 1) - math.lgamma(w + 1) - math.lgamma(d - w + 1)
            + w * math.log(t) + (d - w) * math.log1p(-t) for w in ws]
    top = max(logp)
    p = [math.exp(v - top) for v in logp]
    z = sum(p)
    mean = sum(w * q for w, q in zip(ws, p)) / z
    var = sum((w - mean) ** 2 * q for w, q in zip(ws, p)) / z
    return mean, var


def density_z(scheme: str, theta: float | None, d: int, n: int,
              queries: int, ones: float) -> float:
    """How many standard deviations the ones counted in ``queries``
    queries' masks lie from what the scheme draws: each query has n − 1
    even columns and one odd, the columns independent."""
    me, ve = weight_moments(scheme, theta, d, odd=False)
    mo, vo = weight_moments(scheme, theta, d, odd=True)
    mean = queries * ((n - 1) * me + mo)
    var = queries * ((n - 1) * ve + vo)
    return abs(ones - mean) / math.sqrt(var)


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
