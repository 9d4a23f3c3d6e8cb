// K4 `rfc6962_root`: the RFC-6962 Merkle root over n (a power of two, at
// most 1024) 32-byte leaf hashes, one tree per block.
//
// Replaces: celestia_tpu/ops/nmt.py:272 `rfc6962_root_pow2` (its inner
// levels, :267 `rfc6962_inner`).  The leaf hashes sha256(0x00 || root)
// (:261 `rfc6962_leaf_hashes`) are K1 launched with a 0x00 prefix.
//
// Bound on the H100: latency.  The data root of a k = 128 block is 511
// two-block compressions in log2(512) = 9 dependent levels -- microseconds
// of work that no more than 256 threads can share.
// Design: one block holds the whole tree in 32 KB of static shared memory;
// level by level, thread j hashes `0x01 || node[2j] || node[2j+1]` (65 B)
// and, after a barrier, writes the parent in place.  One launch per tree,
// no round trip through HBM between levels.
//
// Output (K7a's root tree, celestia_tpu/ops/nmt.py:287
// `rfc6962_level_stack`): every level is written from shared memory, as the
// block builds it, into a packed uint8[batch, 2n - 1, 32] buffer -- the n
// leaf hashes first, then n/2, ..., the root last -- so a data-root proof is
// a gather of `level[j][(i >> j) ^ 1]` and the root is the last row.
#include <cuda_runtime.h>

#include "nmt.cuh"

namespace {

constexpr uint32_t kMaxLeaves = 1024;

// Copy the level of `count` nodes now in shared memory to its place in the
// packed levels buffer.
__device__ void store_level(const uint8_t* nodes, uint8_t* level, uint32_t count) {
  for (uint32_t i = threadIdx.x; i < count * 32u; i += blockDim.x) level[i] = nodes[i];
}

__global__ void rfc6962_tree_kernel(const uint8_t* leaves, uint8_t* levels, uint32_t n) {
  __shared__ __align__(16) uint8_t nodes[kMaxLeaves * 32];
  const uint8_t* src = leaves + static_cast<uint64_t>(blockIdx.x) * n * 32u;
  uint8_t* level = levels + static_cast<uint64_t>(blockIdx.x) * (2u * n - 1u) * 32u;
  for (uint32_t i = threadIdx.x; i < n * 32u; i += blockDim.x) nodes[i] = src[i];
  __syncthreads();
  store_level(nodes, level, n);
  for (uint32_t m = n; m > 1; m >>= 1) {
    const uint32_t j = threadIdx.x;
    const bool active = j < m / 2;
    uint32_t st[8];
    if (active) ctt::rfc6962_inner_body(nodes, j, st);
    __syncthreads();
    if (active) ctt::store_digest(st, nodes + 32u * j);
    __syncthreads();
    // read-only until the next level's barrier, so no further barrier here
    level += m * 32u;
    store_level(nodes, level, m / 2);
  }
}

}  // namespace

// levels_out: uint8[batch, 2n - 1, 32].
extern "C" int ctt_rfc6962_root(const void* leaves, void* levels_out, int batch, int n,
                                void* stream) {
  const int threads = n / 2 > 32 ? n / 2 : 32;
  rfc6962_tree_kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(leaves), static_cast<uint8_t*>(levels_out),
      static_cast<uint32_t>(n));
  return static_cast<int>(cudaGetLastError());
}
