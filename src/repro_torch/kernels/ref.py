"""The plain PyTorch versions of every ported kernel, under the reference
package's oracle names. PIR is bit-exact, so the kernels are held equal to
these with tolerance zero.

``scatter_rows_ref`` resolves duplicate rows to the last write, as the
reference's kernel and host replay do; the reference's own jnp oracle
leaves that order to XLA and is only defined on unique rows.

``flash_attention_ref`` is float: the attention kernel is held to it within
a tolerance (the kernel's sums run in another order)."""

from __future__ import annotations

from repro_torch.kernels.flash_attention import (
    flash_attention_plain as flash_attention_ref,
)
from repro_torch.kernels.gather_xor import gather_xor_plain as gather_xor_ref
from repro_torch.kernels.parity_matmul import (
    parity_matmul_plain as parity_matmul_ref,
)
from repro_torch.kernels.scatter import scatter_rows_plain as scatter_rows_ref
from repro_torch.kernels.xor_fold import xor_fold_plain as xor_fold_ref

__all__ = [
    "xor_fold_ref",
    "parity_matmul_ref",
    "gather_xor_ref",
    "scatter_rows_ref",
    "flash_attention_ref",
]
