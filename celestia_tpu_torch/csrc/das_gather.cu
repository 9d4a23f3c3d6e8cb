// K7b `das_proof_gather`: the proof paths of n DAS samples -- each cell's
// row-tree NMT siblings (90 B), its row root's RFC-6962 aunts (32 B) and the
// cell's share (512 B) -- copied from a device-resident block's tensors into
// one packed uint8 buffer, which the host fetches with one copy.
//
// Replaces: celestia_tpu/da/device_plane.py:286 `sample_proofs_batch`, whose
// eager per-level gathers (:318-334: `levels[l][0, rows, idxs]` for every
// level, `root_levels[j][idxs]` for every root level, `eds[rows, cols]`)
// each upload two index arrays and launch their own gather.
//
// Bound on the H100: bytes, and below them latency.  1,024 cells at k = 128
// move 1.56 MB out (8 x 90 + 9 x 32 + 512 = 1,520 B a cell), the same read,
// and a 295 KB index table: ~1 us of HBM time, under one launch's cost.
// Design: the host works out every item's (source, row, idx, offset) and
// uploads that one int32 table; the sources' base pointers and strides
// travel by value as a kernel parameter (no upload).  One warp per item:
// its lanes copy the item's bytes (items start at any byte offset, so the
// copy is by bytes).  One launch serves the whole batch.
#include <cuda_runtime.h>

#include "das_gather.cuh"

namespace {

struct GatherSrcs {
  ctt::GatherSrc s[ctt::kMaxGatherSrcs];
};

constexpr uint32_t kWarpsPerBlock = 4;

__global__ void das_gather_kernel(GatherSrcs srcs, uint32_t n_srcs, const int32_t* items,
                                  uint8_t* out, uint32_t n_items) {
  __shared__ ctt::GatherSrc sh[ctt::kMaxGatherSrcs];
  for (uint32_t i = threadIdx.x; i < n_srcs; i += blockDim.x) sh[i] = srcs.s[i];
  __syncthreads();
  const uint32_t item = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32u;
  if (item >= n_items) return;
  ctt::das_gather_body(sh, items, out, item, threadIdx.x % 32u, 32u);
}

}  // namespace

// srcs: host array of n_srcs x 4 int64 (base pointer, row stride, item
// stride, width); items: device int32[n_items, 4]; out: device uint8.
extern "C" int ctt_das_proof_gather(const long long* srcs, int n_srcs, const void* items,
                                    int n_items, void* out, void* stream) {
  if (n_srcs < 1 || n_srcs > static_cast<int>(ctt::kMaxGatherSrcs) || n_items < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  GatherSrcs table = {};
  for (int i = 0; i < n_srcs; ++i) {
    table.s[i].base = reinterpret_cast<const uint8_t*>(static_cast<uintptr_t>(srcs[4 * i]));
    table.s[i].row_stride = static_cast<uint64_t>(srcs[4 * i + 1]);
    table.s[i].item_stride = static_cast<uint32_t>(srcs[4 * i + 2]);
    table.s[i].width = static_cast<uint32_t>(srcs[4 * i + 3]);
  }
  const unsigned blocks = (static_cast<unsigned>(n_items) + kWarpsPerBlock - 1) / kWarpsPerBlock;
  das_gather_kernel<<<blocks, kWarpsPerBlock * 32u, 0, static_cast<cudaStream_t>(stream)>>>(
      table, static_cast<uint32_t>(n_srcs), static_cast<const int32_t*>(items),
      static_cast<uint8_t*>(out), static_cast<uint32_t>(n_items));
  return static_cast<int>(cudaGetLastError());
}
