// fused_multi_gather_fold: the jagged multi-index answer with the [n, BW]
// db slab resident on chip. Output row r*k_max + i is the XOR of the slab
// rows named by idx[r*k_max + i] when i < offsets[r+1] - offsets[r], and
// zero otherwise, whatever that index row holds.
//
// Replaces the TPU kernel of the reference package's kernels/fused.py
// (`_multi_kernel`: the jagged descriptor in scalar memory, one grid step
// per (request, word block) folding all k_max index rows of the request
// against the resident block).
//
// Bound: bytes, as for fused_gather_fold: the distinct rows the LIVE index
// rows name, the live index rows and the output, over the memory rate. The
// kernel reads each word tile's slab once per thread-block cluster.
//
// Design: fused_gather_fold's (fused_slab.cuh), with whole requests as the
// unit a CTA owns. A CTA's warps fold its requests' rows side by side (one
// or more warps a row); a row reads its request's count from the offsets
// and, when dead, is written zero without a read of its ids. "rw" spreads
// the requests as "qw" spreads queries, "wr" packs them as "wq" does.
#include "fused_slab.cuh"

// out ([requests * k_max, w]) needs no zeroing; offsets is [requests + 1]
// in device memory. The schedule's arguments are fused.py::fused_schedule's.
PIR_EXPORT int pir_fused_multi_gather_fold(const void* db, const void* idx,
                                           const void* offsets, void* out,
                                           int n, int w, int requests,
                                           int k_max, int m, int block_w,
                                           int cluster, int groups,
                                           int rows_per_cta, int wpq,
                                           int staging, void* stream) {
  if (requests <= 0 || k_max <= 0) return (int)cudaErrorInvalidValue;
  return pir_slab::launch<true>(db, idx, offsets, out, n, w,
                                requests * k_max, k_max, m, block_w, cluster,
                                groups, rows_per_cta, wpq, staging,
                                static_cast<cudaStream_t>(stream));
}
