// K2 `nmt_leaf_digests` and K3 `nmt_combine_level`: the 4k namespaced
// Merkle trees of an extended data square.
//
// Replaces: celestia_tpu/ops/nmt.py:83 `eds_prefixed_leaves` + :42
// `leaf_digests` (K2), and :53 `combine_level` / :69 `nmt_roots` / :104
// `eds_nmt_roots` (K3).
//
// Bound on the H100: integer issue of the SHA-256 compressions (9 per
// 542-byte leaf, 3 per 181-byte node); the 2k x 2k x 512 EDS read is ~10 us
// of HBM time at k = 128 against ~0.1 ms of hashing.
// Design: K2 hashes every cell ONCE, one thread per cell, straight from the
// EDS: the message `0x00 || prefix || share` is read in place (no 541-byte
// prefixed leaf is built) into a (2k, 2k, 90) digest grid.  The JAX program
// hashes each cell twice (row and transposed column trees); the grid read
// by rows and by columns gives the same bytes for half the leaf work.  K3 is
// one launch per level, one thread per parent node; its first level reads
// the grid through two stride sets (rows for trees 0..2k, columns for
// 2k..4k), later levels read the contiguous previous level.  K2 also takes
// a window of EDS rows (a K9 shard's slab, parallel/sharded.py).  A batch of
// EDSs (the catch-up path, JAX `jax.vmap(eds_nmt_roots)` at
// celestia_tpu/node/network.py:407) is one K2 launch over every cell and
// one K3 launch per level over all n * 4k trees (groups of 4k per grid).
#include <cuda_runtime.h>

#include "nmt.cuh"

namespace {

__global__ void nmt_leaf_kernel(const uint8_t* eds, uint8_t* out, uint32_t n2, uint32_t row0,
                                uint32_t n_rows, uint32_t cells) {
  const uint32_t cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= cells) return;
  ctt::nmt_leaf_body(eds, out, n2, row0, n_rows, cell);
}

__global__ void nmt_combine_kernel(const uint8_t* in, uint8_t* out, uint64_t total,
                                   uint32_t m_out, uint32_t split, uint64_t ts0, uint64_t ns0,
                                   uint64_t ts1, uint64_t ns1, uint64_t tpb, uint64_t bs) {
  const uint64_t idx = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  ctt::nmt_combine_body(in, out, m_out, split, ts0, ns0, ts1, ns1, tpb, bs, idx);
}

}  // namespace

// eds uint8[batch, n_rows, n2, 512], rows row0 .. row0 + n_rows - 1 of each
// EDS -> out uint8[batch, n_rows, n2, 90].  A whole EDS: row0 = 0, n_rows = n2.
extern "C" int ctt_nmt_leaf_digests(const void* eds, void* out, int n2, int batch, int row0,
                                    int n_rows, void* stream) {
  const int threads = 128;
  const unsigned cells =
      static_cast<unsigned>(batch) * static_cast<unsigned>(n_rows) * static_cast<unsigned>(n2);
  nmt_leaf_kernel<<<(cells + threads - 1) / threads, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(eds), static_cast<uint8_t*>(out), n2, row0, n_rows, cells);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ctt_nmt_combine_level(const void* in, void* out, long long ntrees, int m_out,
                                     long long split, long long ts0, long long ns0,
                                     long long ts1, long long ns1, long long tpb, long long bs,
                                     void* stream) {
  const int threads = 128;
  const uint64_t total = static_cast<uint64_t>(ntrees) * static_cast<uint64_t>(m_out);
  nmt_combine_kernel<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), total,
      static_cast<uint32_t>(m_out), static_cast<uint32_t>(split), ts0, ns0, ts1, ns1, tpb, bs);
  return static_cast<int>(cudaGetLastError());
}
