"""CUDA kernels for the PIR server hot paths (the compute the paper
optimizes): xor_fold (dense masked fold), parity_matmul (the fold as an
integer product mod 2; parity_matmul_packed returns the bits packed),
gather_xor (Sparse-PIR: only the θ·n selected rows), fused_gather_fold
(the same with the db slab in shared memory) and its jagged multi-index
form fused_multi_gather_fold, plus scatter_rows, the write kernel of
live-store ingest, and flash_attention_fwd, the attention forward of the
models (repro_torch.models). Each module holds the wrapper that launches
the CUDA kernel and the plain PyTorch version beside it; ops.py holds the
standalone server paths, ref.py the plain versions under the reference's
oracle names, and backend.py the execution-backend layer every PIR
consumer outside this package goes through, with the autotune table
of its measured decisions."""

from repro_torch.kernels import backend, ops, ref
from repro_torch.kernels.backend import (
    AutotuneTable,
    ExecutionPlan,
    KernelPlanner,
    autotune_table,
    dump_autotune,
    get_backend,
    load_autotune,
    register_backend,
    registered_backends,
    scatter_update,
    shard_answer_fn,
)
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.fused import (
    fused_block_w,
    fused_gather_fold,
    fused_multi_gather_fold,
    fused_smem_budget,
    jagged_row_mask,
)
from repro_torch.kernels.gather_xor import gather_xor, indices_from_mask
from repro_torch.kernels.parity_matmul import (
    parity_matmul,
    parity_matmul_packed,
)
from repro_torch.kernels.xor_fold import xor_fold

__all__ = [
    "AutotuneTable",
    "ExecutionPlan",
    "KernelPlanner",
    "autotune_table",
    "backend",
    "dump_autotune",
    "flash_attention_fwd",
    "fused_block_w",
    "fused_smem_budget",
    "get_backend",
    "indices_from_mask",
    "jagged_row_mask",
    "load_autotune",
    "ops",
    "ref",
    "register_backend",
    "registered_backends",
    "scatter_update",
    "shard_answer_fn",
]
