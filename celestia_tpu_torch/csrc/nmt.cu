// K2 `nmt_leaf_digests` and K3 `nmt_combine_level` (C entry
// ctt_nmt_reduce_levels): the 4k namespaced Merkle trees of an extended
// data square.
//
// Replaces: celestia_tpu/ops/nmt.py:83 `eds_prefixed_leaves` + :42
// `leaf_digests` (K2), and :53 `combine_level` / :69 `nmt_roots` / :104
// `eds_nmt_roots` / :326 `nmt_level_stack` (K3).
//
// Bound on the H100: integer issue of the SHA-256 compressions (9 per
// 542-byte leaf, 3 per 181-byte node); the 2k x 2k x 512 EDS read is ~10 us
// of HBM time at k = 128 against ~0.05 ms of hashing.  Above K3's first
// levels the bound is the dependency chain: log2(2k) levels of 3
// compressions each, one after another.
//
// K2 design: each EDS cell is hashed ONCE into a (2k, 2k, 90) digest grid
// that K3 reads by rows and by columns (the JAX program hashes every cell
// twice).  A block of 64 threads hashes 64 consecutive cells: it stages
// their shares with 16-byte loads (a warp reads one whole share a load)
// into shared memory at a 516-byte row stride (conflict-free reads), each
// thread reads its message words there (one PRMT of two staged words each,
// the share starting 2 bytes into a word), and the block writes its 5,760
// bytes of digests as one run of 16-byte stores.  It takes a window of EDS
// rows (a K9 shard's slab, parallel/sharded.py) and a batch of EDSs.  Its
// row-set mode (ctt_nmt_leaf_digests_rows) hashes the row trees of a proof,
// a namespace query, a BEFP or a DAS miss straight from the EDS rows, read
// in place or from a gathered block: the same steps, each block's shares
// staged from its trees' source rows, the Q0 rule read at the row ids,
// which travel by value in the launch's parameters (no upload per call).
// It replaces, on those paths, K1 over a 541-byte prefixed-leaf tensor built
// for the purpose (celestia_tpu/ops/nmt.py:326 `nmt_level_stack` over the
// rows' prefixed leaves).
//
// K3 design: one launch runs every level of a set of trees.  A block stages
// up to 512 level-0 nodes -- one tree of 512 leaves, two rows or two
// columns of a k = 128 leaf grid, 512 / m trees of m leaves -- into shared
// memory with wide coalesced copies (by rows: one run of 16-byte loads; by
// columns: the block's adjacent columns are one run of each grid row), then
// reduces them level by level in shared memory, one thread a parent, with a
// barrier between levels, and writes each level to the packed output with
// coalesced stores as soon as it has it.  No level crosses a launch.  The
// first level reads the leaf grid through two stride sets (rows for trees
// 0..2k, columns for 2k..4k), and groups of trees take a batch of grids (the
// catch-up path, JAX `jax.vmap(eds_nmt_roots)` at celestia_tpu/node/
// network.py:407).
#include <cuda_runtime.h>

#include "nmt.cuh"
#include "launch.cuh"

namespace {

__global__ void __launch_bounds__(ctt::kLeafCells)
    nmt_leaf_kernel(const uint8_t* eds, uint8_t* out, uint32_t lg_n2, uint32_t row0,
                    uint32_t n_rows, uint32_t cells) {
  __shared__ __align__(16) uint8_t rows[ctt::kLeafSmemBytes];
  const uint32_t cell0 = blockIdx.x * ctt::kLeafCells;
  const uint32_t n = cells - cell0 < ctt::kLeafCells ? cells - cell0 : ctt::kLeafCells;
  const uint32_t t = threadIdx.x;
  ctt::nmt_leaf_stage(eds, cell0, n, rows, t, blockDim.x);
  __syncthreads();
  ctt::LeafHash h;
  if (t < n) ctt::nmt_leaf_hash(rows + t * ctt::kLeafRow, ctt::nmt_leaf_q0(cell0 + t, lg_n2, row0, n_rows), &h);
  __syncthreads();  // every share read: the digests may overwrite them
  if (t < n) ctt::nmt_leaf_digest(h, rows + t * ctt::kDigest);
  __syncthreads();
  ctt::nmt_leaf_store(out, cell0, n, rows, t, blockDim.x);
}

// K2's row-set mode: the same steps, the shares staged from each tree's
// source row and the Q0 rule read at its EDS row id.
__global__ void __launch_bounds__(ctt::kLeafCells)
    nmt_leaf_rows_kernel(const ctt::NmtRowSet a) {
  __shared__ __align__(16) uint8_t rows[ctt::kLeafSmemBytes];
  const uint32_t cell0 = blockIdx.x * ctt::kLeafCells;
  const uint32_t n = a.cells - cell0 < ctt::kLeafCells ? a.cells - cell0 : ctt::kLeafCells;
  const uint32_t t = threadIdx.x;
  ctt::nmt_rows_stage(a, cell0, n, rows, t, blockDim.x);
  __syncthreads();
  ctt::LeafHash h;
  if (t < n) ctt::nmt_leaf_hash(rows + t * ctt::kLeafRow, ctt::nmt_rows_q0(a, cell0 + t), &h);
  __syncthreads();  // every share read: the digests may overwrite them
  if (t < n) ctt::nmt_leaf_digest(h, rows + t * ctt::kDigest);
  __syncthreads();
  ctt::nmt_leaf_store(a.out, cell0, n, rows, t, blockDim.x);
}

__global__ void __launch_bounds__(ctt::kNmtThreads)
    nmt_reduce_kernel(const ctt::NmtReduceArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const buf_a = smem;
  uint8_t* const buf_b = smem + ctt::kNmtTileLeaves * ctt::kDigest;
  const ctt::NmtTile t = ctt::nmt_tile(a, blockIdx.x, blockIdx.y);
  ctt::nmt_stage(t, buf_a, threadIdx.x, blockDim.x);
  __syncthreads();
  for (uint32_t j = 1; j <= a.n_levels; ++j) {
    const uint8_t* in = (j & 1u) ? buf_a : buf_b;
    uint8_t* out = (j & 1u) ? buf_b : buf_a;
    ctt::nmt_level_step(a, t, j, in, out, threadIdx.x);
    __syncthreads();
    // `out` is read-only until level j + 2 writes it, two barriers on
    ctt::nmt_store_level(a, t, j, out, threadIdx.x, blockDim.x);
  }
}

}  // namespace

// eds uint8[batch, n_rows, n2, 512] (16-byte aligned), rows row0 .. row0 +
// n_rows - 1 of each EDS -> out uint8[batch, n_rows, n2, 90].  A whole EDS:
// row0 = 0, n_rows = n2.
extern "C" int ctt_nmt_leaf_digests(const void* eds, void* out, int n2, int batch, int row0,
                                    int n_rows, void* stream) {
  const uint32_t lg_n2 = ctt::log2_exact(static_cast<uint64_t>(n2));
  const uint64_t cells = uint64_t(batch) * uint64_t(n_rows) * uint64_t(n2);
  if (lg_n2 < 1 || lg_n2 > 15 || n_rows < 1 || batch < 1 || cells > 0xFFFFFFFFull ||
      (reinterpret_cast<uintptr_t>(eds) & 15u) || (reinterpret_cast<uintptr_t>(out) & 1u))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks =
      static_cast<unsigned>((cells + ctt::kLeafCells - 1) / ctt::kLeafCells);
  nmt_leaf_kernel<<<blocks, ctt::kLeafCells, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(eds), static_cast<uint8_t*>(out), lg_n2,
      static_cast<uint32_t>(row0), static_cast<uint32_t>(n_rows), static_cast<uint32_t>(cells));
  return static_cast<int>(cudaGetLastError());
}

// K2's row-set mode: the leaf digests of the n_trees row trees whose EDS
// row ids are ids[0 .. n_trees) (a host array, copied into the launch's
// parameters) into out uint8[n_trees, n2, 90].  Tree i's shares are row
// row_i of src uint8[rows, n2, 512] (16-byte aligned), row_i = ids[i] when
// in_place (the EDS itself), else i (the rows gathered into a block).
extern "C" int ctt_nmt_leaf_digests_rows(const void* src, void* out, int n2, int n_trees,
                                         const void* ids, int in_place, void* stream) {
  ctt::NmtRowSet a{};
  if (n2 < 1 || n_trees < 1 ||
      !ctt::nmt_rows_setup(&a, static_cast<const uint8_t*>(src), static_cast<uint8_t*>(out),
                           static_cast<uint32_t>(n2), static_cast<uint32_t>(n_trees),
                           static_cast<const uint16_t*>(ids), static_cast<uint32_t>(in_place)))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = (a.cells + ctt::kLeafCells - 1) / ctt::kLeafCells;
  nmt_leaf_rows_kernel<<<blocks, ctt::kLeafCells, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Levels 1 .. n_levels of ntrees trees of m leaves (strides as
// ctt::NmtReduceArgs describes) into the packed out: level j is uint8[ntrees,
// m >> j, 90] from byte ntrees * (m - (m >> (j - 1))) * 90 on; m <= 512
// (one block's tree), 1 <= n_levels <= log2 m.
extern "C" int ctt_nmt_reduce_levels(const void* in, void* out, long long ntrees, int m,
                                     int n_levels, long long split, long long ts0, long long ns0,
                                     long long ts1, long long ns1, long long tpb, long long bs,
                                     void* stream) {
  ctt::NmtReduceArgs a{};
  const uint32_t per_group = ctt::nmt_reduce_setup(
      &a, static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<uint64_t>(ntrees), static_cast<uint32_t>(m), static_cast<uint32_t>(n_levels),
      static_cast<uint64_t>(split), static_cast<uint64_t>(ts0), static_cast<uint64_t>(ns0),
      static_cast<uint64_t>(ts1), static_cast<uint64_t>(ns1), static_cast<uint64_t>(tpb),
      static_cast<uint64_t>(bs));
  const uint64_t groups = per_group ? static_cast<uint64_t>(ntrees / tpb) : 0;
  if (per_group == 0 || groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = ctt::raise_smem_once<nmt_reduce_kernel>(ctt::kNmtSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  nmt_reduce_kernel<<<dim3(per_group, static_cast<unsigned>(groups)), ctt::kNmtThreads,
                      ctt::kNmtSmemBytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
