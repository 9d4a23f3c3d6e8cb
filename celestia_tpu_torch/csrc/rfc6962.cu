// K4 `rfc6962_root`: the RFC-6962 Merkle tree over n (a power of two, at
// most 1024) leaves, from the leaves to the root, one tree per block.
//
// Replaces: celestia_tpu/ops/nmt.py:272 `rfc6962_root_pow2` and :287
// `rfc6962_level_stack` as a whole: the leaf hashes sha256(0x00 || leaf)
// (:261 `rfc6962_leaf_hashes`) and every inner level (:267
// `rfc6962_inner`).  Without its leaf pass the same kernel builds the tree
// over given 32-byte leaf hashes.
//
// Bound on the H100: latency.  The data root of a k = 128 block is 512
// two-block leaf hashes, then 511 two-block inner nodes in log2(512) = 9
// dependent levels: (9 + 1) x 2 compressions one after another, work that
// no more than 512 threads can share.
//
// Design (pieces in nmt.cuh, the inner node in sha256.cuh):
// - the block stages its tree's leaves (512 x 90 bytes on the main path)
//   in shared memory with 16-byte loads from the run's aligned cover,
//   whatever its alignment (K3's packed roots are 2-byte aligned);
// - one thread a leaf hashes `0x00 || leaf`, its message words one PRMT of
//   two aligned shared words, and writes the state words to 8 word planes;
// - each inner level is one thread a parent: its children are 8 aligned
//   8-byte loads, the 65-byte message is built by PRMTs in registers, the
//   second block's 15 constant words fold into the schedule;
// - the threads with no parent to compute write the finished level out as
//   16-byte stores (neighbouring threads, neighbouring bytes) while the
//   others compute the next one; the planes hold every level, so nothing
//   is overwritten and the stores need no barrier;
// - once at most 32 nodes remain, warp 0 runs the last levels alone, with
//   __syncwarp between them instead of a block barrier.
//
// Output (K7a's root tree): every level in one packed uint8[batch, 2n - 1,
// 32] buffer -- the n leaf hashes first, then n/2, ..., the root last -- so
// a data-root proof is a gather of `level[j][(i >> j) ^ 1]` and the root is
// the last row.
#include <cuda_runtime.h>

#include "nmt.cuh"
#include "launch.cuh"

namespace {

__global__ void __launch_bounds__(ctt::kRfcMaxThreads) rfc6962_tree_kernel(const ctt::RfcArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* const planes = reinterpret_cast<uint32_t*>(smem);
  uint8_t* const stage = smem + a.stage_off;
  const uint32_t tid = threadIdx.x, nt = blockDim.x;
  for (uint32_t t0 = 0; t0 < a.n; t0 += a.tile) {
    const ctt::RfcTile t = ctt::rfc6962_tile(a, blockIdx.x, t0);
    ctt::rfc6962_stage(t, stage, tid, nt);
    __syncthreads();
    ctt::rfc6962_leaf(a, t, stage, planes, tid);
    __syncthreads();  // level 0 complete; the staging buffer free again
  }
  uint8_t* const tree = a.out + static_cast<uint64_t>(blockIdx.x) * (2u * a.n - 1u) * 32u;
  // one loop, so the step (and its two compressions) is one copy of code:
  // a launch fetches each straight-line region of the kernel cold, and a
  // second copy for the warp's levels was slower (a variant timed on the
  // card)
  for (uint32_t m = a.n; m >= 1; m >>= 1) {
    const bool block_wide = m > ctt::kRfcWarpNodes;  // uniform over the block
    if (!block_wide && tid >= 32) return;
    ctt::rfc6962_level_step(a, planes, tree, m, tid, block_wide ? nt : 32u);
    if (block_wide)
      __syncthreads();
    else
      __syncwarp();
  }
}

}  // namespace

// in: leaves uint8[batch, n, L] (leaf_pass = 1) or level-0 hashes
// uint8[batch, n, 32] (leaf_pass = 0); levels_out: uint8[batch, 2n - 1, 32]
// (16-byte aligned).  cudaErrorInvalidValue for what rfc6962_setup refuses.
extern "C" int ctt_rfc6962_root(const void* in, void* levels_out, int batch, int n, int L,
                                int leaf_pass, void* stream) {
  ctt::RfcArgs a{};
  const uint32_t threads = ctt::rfc6962_setup(
      &a, static_cast<const uint8_t*>(in), static_cast<uint8_t*>(levels_out),
      static_cast<uint64_t>(batch > 0 ? batch : 0), static_cast<uint32_t>(n > 0 ? n : 0),
      static_cast<uint32_t>(L > 0 ? L : 0), static_cast<uint32_t>(leaf_pass));
  if (threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = ctt::raise_smem_once<rfc6962_tree_kernel>(ctt::kRfcMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rfc6962_tree_kernel<<<static_cast<unsigned>(batch), threads, a.smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
