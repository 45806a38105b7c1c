"""Deterministic synthetic data, stateless in (seed, step)."""

from repro_torch.data.pipeline import bert4rec_batch, lm_batch, pir_delta_batch

__all__ = ["bert4rec_batch", "lm_batch", "pir_delta_batch"]
