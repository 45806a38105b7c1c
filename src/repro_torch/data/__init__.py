"""Deterministic synthetic data, stateless in (seed, step)."""

from repro_torch.data.pipeline import pir_delta_batch

__all__ = ["pir_delta_batch"]
