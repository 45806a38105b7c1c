"""The plain PyTorch versions of every ported kernel, under the reference
package's oracle names. PIR is bit-exact, so the kernels are held equal to
these with tolerance zero."""

from __future__ import annotations

from repro_torch.kernels.gather_xor import gather_xor_plain as gather_xor_ref
from repro_torch.kernels.parity_matmul import (
    parity_matmul_plain as parity_matmul_ref,
)
from repro_torch.kernels.xor_fold import xor_fold_plain as xor_fold_ref

__all__ = ["xor_fold_ref", "parity_matmul_ref", "gather_xor_ref"]
