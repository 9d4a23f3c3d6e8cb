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
// move 1.56 MB out (512 + 9 x 32 + 8 x 90 = 1,520 B a cell), the same read,
// and 12 KB of (row, tree_row, col) triples: ~1 us of HBM time, under one
// launch's cost.  So the design removes what stands between the launch and
// the payload's loads.  The cell mode (`ctt_das_cell_gather`, the DAS path)
// takes only the triples: a cell's threads derive its 18 items from its
// coordinates (das_gather.cuh cell_pieces), so the triple is the only load
// the payload waits on; each thread then issues all its 16-byte loads
// before its one store, the digests at 2-byte-aligned offsets read from
// their aligned cover and shifted in registers, and writes one 16-byte
// word of the cell's record (share, aunts, siblings, padded to 16 B; 95
// words, three warps, at k = 128).  One thread a word beat one warp a cell
// with three words a lane by about a seventh in a probe on the H100 (1-4
// words a thread, timed in one call).
// The table mode (`ctt_das_proof_gather`, the range proofs of da/proof.py)
// keeps a host-built table of items, one warp an item, with the same
// 16-byte copy.  The sources' base pointers and strides travel by value as
// a kernel parameter (no upload).
#include <cuda_runtime.h>

#include "das_gather.cuh"

namespace {

struct GatherSrcs {
  ctt::GatherSrc s[ctt::kMaxGatherSrcs];
};

constexpr uint32_t kWarpsPerBlock = 4;

__device__ __forceinline__ void stage_sources(const GatherSrcs& srcs, uint32_t n_srcs,
                                              ctt::GatherSrc* sh) {
  for (uint32_t i = threadIdx.x; i < n_srcs; i += blockDim.x) sh[i] = srcs.s[i];
  __syncthreads();
}

__global__ void das_gather_kernel(GatherSrcs srcs, uint32_t n_srcs, const int32_t* items,
                                  uint8_t* out, uint32_t n_items) {
  __shared__ ctt::GatherSrc sh[ctt::kMaxGatherSrcs];
  stage_sources(srcs, n_srcs, sh);
  const uint32_t item = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32u;
  if (item >= n_items) return;
  ctt::das_gather_body(sh, items, out, item, threadIdx.x % 32u, 32u);
}

// cells_per_block cells of `lanes` threads each (ctt::cell_lanes), a
// thread a word.
__global__ void das_cell_kernel(GatherSrcs srcs, uint32_t n_srcs, ctt::CellArgs a,
                                const int32_t* cells, uint8_t* out, uint32_t n_cells,
                                uint32_t lanes, uint32_t cells_per_block) {
  __shared__ ctt::GatherSrc sh[ctt::kMaxGatherSrcs];
  const uint32_t cell = blockIdx.x * cells_per_block + threadIdx.x / lanes;
  int32_t t[3] = {0, 0, 0};
  if (cell < n_cells) {  // the one load the payload waits on, issued first
    for (uint32_t i = 0; i < 3; ++i) t[i] = cells[3u * cell + i];
  }
  stage_sources(srcs, n_srcs, sh);
  if (cell >= n_cells) return;
  ctt::das_cell_word(a, sh, static_cast<uint32_t>(t[0]), static_cast<uint32_t>(t[1]),
                     static_cast<uint32_t>(t[2]), out + static_cast<uint64_t>(cell) * 16u * a.words,
                     threadIdx.x % lanes);
}

// A launch and one load the store waits on, and nothing else: the latency
// floor of a gather that is shorter than a launch (chip_smoke.py times it
// as it times K7b).  One warp; loads = 0 is the empty launch.
__global__ void dependent_load_kernel(const uint4* src, uint4* dst, int loads) {
  if (loads) dst[threadIdx.x] = src[threadIdx.x];
}

bool read_sources(const long long* srcs, int n_srcs, GatherSrcs* table) {
  if (n_srcs < 1 || n_srcs > static_cast<int>(ctt::kMaxGatherSrcs)) return false;
  *table = GatherSrcs{};
  for (int i = 0; i < n_srcs; ++i) {
    table->s[i].base = reinterpret_cast<const uint8_t*>(static_cast<uintptr_t>(srcs[4 * i]));
    table->s[i].row_stride = static_cast<uint64_t>(srcs[4 * i + 1]);
    table->s[i].item_stride = static_cast<uint32_t>(srcs[4 * i + 2]);
    table->s[i].width = static_cast<uint32_t>(srcs[4 * i + 3]);
  }
  return true;
}

unsigned warp_blocks(int n) {
  return (static_cast<unsigned>(n) + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

}  // namespace

// srcs: host array of n_srcs x 4 int64 (base pointer, row stride, item
// stride, width); items: device int32[n_items, 4]; out: device uint8,
// 16-byte aligned.
extern "C" int ctt_das_proof_gather(const long long* srcs, int n_srcs, const void* items,
                                    int n_items, void* out, void* stream) {
  GatherSrcs table;
  if (!read_sources(srcs, n_srcs, &table) || n_items < 1 ||
      (reinterpret_cast<uintptr_t>(out) & 15u))
    return static_cast<int>(cudaErrorInvalidValue);
  das_gather_kernel<<<warp_blocks(n_items), kWarpsPerBlock * 32u, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      table, static_cast<uint32_t>(n_srcs), static_cast<const int32_t*>(items),
      static_cast<uint8_t*>(out), static_cast<uint32_t>(n_items));
  return static_cast<int>(cudaGetLastError());
}

// The cell mode.  srcs as above, laid out as CellArgs names them (NMT
// levels from sib0, root-tree levels from aunt0, the EDS at `share`, each
// item of its width: 90, 32, 512); cells: device int32[n_cells, 3] of
// (row, tree_row, col); out: device uint8[n_cells, 16 * words], 16-byte
// aligned.  Refuses a layout that names a source past n_srcs.
extern "C" int ctt_das_cell_gather(const long long* srcs, int n_srcs, int n_sib, int sib0,
                                   int n_aunt, int aunt0, int share, const void* cells,
                                   int n_cells, void* out, void* stream) {
  GatherSrcs table;
  if (!read_sources(srcs, n_srcs, &table) || n_cells < 1 || n_sib < 1 || n_sib > 16 ||
      n_aunt < 1 || n_aunt > 17 || sib0 < 0 || sib0 + n_sib > n_srcs || aunt0 < 0 ||
      aunt0 + n_aunt > n_srcs || share < 0 || share >= n_srcs ||
      (reinterpret_cast<uintptr_t>(out) & 15u))
    return static_cast<int>(cudaErrorInvalidValue);
  const ctt::CellArgs a = ctt::cell_args(n_sib, sib0, n_aunt, aunt0, share);
  const uint32_t lanes = ctt::cell_lanes(a);
  const uint32_t per_block = lanes < kWarpsPerBlock * 32u ? kWarpsPerBlock * 32u / lanes : 1u;
  const unsigned blocks = (static_cast<unsigned>(n_cells) + per_block - 1) / per_block;
  das_cell_kernel<<<blocks, per_block * lanes, 0, static_cast<cudaStream_t>(stream)>>>(
      table, static_cast<uint32_t>(n_srcs), a, static_cast<const int32_t*>(cells),
      static_cast<uint8_t*>(out), static_cast<uint32_t>(n_cells), lanes, per_block);
  return static_cast<int>(cudaGetLastError());
}

// The latency probe: src, dst 32 x 16 bytes on the card, 16-byte aligned.
extern "C" int ctt_dependent_load_probe(const void* src, void* dst, int loads, void* stream) {
  if ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15u)
    return static_cast<int>(cudaErrorInvalidValue);
  dependent_load_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), loads);
  return static_cast<int>(cudaGetLastError());
}
