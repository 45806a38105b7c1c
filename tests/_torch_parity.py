"""Helpers for the port's parity tests: move data between the JAX
reference and the torch port through numpy, and make seeded inputs."""

import numpy as np
import torch

CPU = torch.device("cpu")

# the suite runs these files in parallel workers beside the JAX tests,
# some of which wait on timers; the port's tests are small, so one
# intra-op thread per worker leaves the other cores to the rest
torch.set_num_threads(1)


def words_t2n(t: torch.Tensor) -> np.ndarray:
    """Packed int32 torch words -> uint32 numpy (the reference's dtype)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def words_n2t(a) -> torch.Tensor:
    """uint32 array (numpy or jax) -> packed int32 torch words."""
    arr = np.ascontiguousarray(np.asarray(a), dtype=np.uint32)
    return torch.from_numpy(arr.view(np.int32))


def seeded_mask(q: int, n: int, seed: int, p: float = 0.4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.random((q, n)) < p).astype(np.uint8)


def seeded_bytes(n: int, rb: int, seed: int) -> np.ndarray:
    """The bytes ``make_synthetic_store(n, rb, seed)`` packs, in either
    package."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, rb), dtype=np.uint8)


def messy_index_rows(rng, n: int, q: int, m: int, kind: str) -> np.ndarray:
    """[q, m] int32 index rows that are not ascending, as no compaction
    emits them: ``shuffled`` ids, ``duplicated`` ids (which cancel in
    pairs), or ``padded`` rows with -1 between the ids; the last row is
    padding alone."""
    idx = np.full((q, m), -1, dtype=np.int32)
    for r in range(q - 1):
        ids = rng.choice(n, size=int(rng.integers(1, max(2, m // 2))),
                         replace=False)
        if kind == "duplicated":
            ids = np.concatenate([ids, ids[: len(ids) // 2],
                                  ids[: len(ids) // 3]])
        ids = rng.permutation(ids)[:m]
        if kind == "padded":
            spots = np.sort(rng.choice(m, size=len(ids), replace=False))
            idx[r, spots] = ids
        else:
            idx[r, : len(ids)] = ids
    return idx
