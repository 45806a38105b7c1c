// fused_gather_fold: gather_xor with the [n, BW] db slab resident on chip.
//
// Replaces the TPU kernel of the reference package's kernels/fused.py
// (`_kernel`: the whole record axis of one word block held in fast memory,
// an in-kernel loop walking the prefetched indices).
//
// Bound: bytes. The function is gather_xor's, so the least time counts
// only the distinct live rows the indices name: distinct*W*4 + q*m*4 +
// q*W*4 bytes over the memory rate. The kernel reads each word tile's slab
// from device memory once per thread-block cluster (one cluster a tile for
// up to 32 queries a CTA), after which the index walk reads shared memory
// only.
//
// Design (fused_slab.cuh): every CTA holds its tile's whole slab. Where a
// tile row is 16 words or more, a cluster of up to 8 CTAs shares one TMA
// multicast of it; 8-word tiles, the gate's edge, W % 4 != 0 and an
// unaligned store take a barrier-free cp.async copy by one CTA a tile. A
// CTA's 16 warps take its queries (a query to 1-16 warps, a lane the row
// of its own id) and store each output word once. The grid orders are
// fused.py::fused_schedule's: "qw" spreads the queries, one a CTA of a
// multicast cluster or 16 a copying CTA; "wq" packs 16 into a multicast
// CTA, 32 into a copying one.
#include "fused_slab.cuh"

// out needs no zeroing: every word of it is written once. The schedule's
// arguments are fused.py::fused_schedule's.
PIR_EXPORT int pir_fused_gather_fold(const void* db, const void* idx,
                                     void* out, int n, int w, int q, int m,
                                     int block_w, int cluster, int groups,
                                     int rows_per_cta, int wpq, int staging,
                                     void* stream) {
  return pir_slab::launch<false>(db, idx, nullptr, out, n, w, q, 1, m,
                                 block_w, cluster, groups, rows_per_cta, wpq,
                                 staging, static_cast<cudaStream_t>(stream));
}

// Clusters of `cluster` CTAs of `smem` bytes the card holds at once (0: it
// cannot hold one).
PIR_EXPORT int pir_fused_active_clusters(int cluster, int smem) {
  return pir_slab::active_clusters<false>(cluster, smem);
}
