// The repair kernels: K8a `rs_decode_matrices`, K8b `rs_decode_axes`, K8c
// `rs_repair_verdicts`.
//
// Replaces: celestia_tpu/ops/rs.py:150 `_decode_matrices_dev` (with the
// tables of :138) as K8a; :206 `_decode_axes_dev` with its GF(2) lift (:191
// `_bit_expand_dev`, :179 `_bit_basis`) and the masked writes of :234
// `_repair_phases` (:249, :252) as K8b; the two verdict masks of :257
// `_repair_verify` (:276-277) as K8c.  The JAX package fuses them with the
// re-extension and the roots into one program per (k, phases) (:295); here
// the host launches them in order on one stream (ops/rs.py).
//
// Bound on the H100 at k = 128, the 256 rows of a 25 % mask:
// - K8b: bytes, the k known cells read and k unknown ones written per axis
//   (~42 MB, ~0.0125 ms), under which the least-work Leopard erasure decode
//   also fits; the JAX package's bit-GEMM computed here, 2 * 8k * 8k * 512
//   per axis, is 275 G int8 operations, 0.139 ms at the 1,979 TOPS int8
//   tensor-core peak (the "tensor-core floor").
// - K8a: k^2 table lookups per output row (small); K8c: three 32 MiB
//   squares read.
// Design:
// - K8a: one block per axis, one thread per output row; the k source
//   points and their denominators are staged in shared memory first.
// - K8b: K5's tensor-core bit-GEMM (rs_extend.cuh) with a per-axis
//   coefficient matrix, the rows of D at the axis's unknown positions, and
//   a per-axis list of known positions as its inputs, read in place through
//   strides (rows or columns; each input is still one contiguous 512-byte
//   share, so the lanes' 8-byte loads hold for both).  A block decodes up
//   to 3 groups of 8 of an axis's k unknown positions (192 KiB of A
//   fragments at k = 128), fewer when the launch has few axes, so the
//   prologue -- the unknown positions ranked from a bitmap of the known
//   ones (rs_decode.cuh), D's rows loaded and expanded -- serves several
//   groups.  Only the solvable axes are launched, only known positions are
//   read and only unknown ones written, so the blocks of an axis never
//   race; this is byte-identical to the JAX program's decode-everything-
//   then-mask.
// - K8c: one warp per cell, 16-byte loads, warp vote into two byte masks.
#include <cuda_runtime.h>

#include "rs_decode.cuh"
#include "launch.cuh"

namespace {

constexpr uint32_t kMaxK = 128;
constexpr uint32_t kShareBytes = 512;
constexpr uint32_t kVerdictCellsPerBlock = 8;

// Block b builds the matrices of axes b * apb .. (at most apb of them).
__global__ void __launch_bounds__(ctt::kDmThreads)
    rs_decode_matrices_kernel(const uint8_t* known, uint8_t* D, const uint8_t* gexp,
                              const uint8_t* glog, uint32_t n, uint32_t lg_k, uint32_t apb,
                              uint32_t xor_const) {
  __shared__ __align__(16) ctt::DmSmem sh;
  const uint32_t tid = threadIdx.x, k = 1u << lg_k;
  const uint64_t a0 = static_cast<uint64_t>(blockIdx.x) * apb;
  const uint32_t na = n - a0 < apb ? static_cast<uint32_t>(n - a0) : apb;
  ctt::rs_dm_stage(sh, known, a0, na, k, xor_const, gexp, glog, tid, blockDim.x);
  __syncthreads();
  // the sums: a group of 4 lanes an item, 8 items a warp at a time
  const uint32_t items = 3 * na * k, lane = tid % 32, per_warp = 32 / ctt::kDmGroup;
  for (uint32_t it0 = (tid / 32) * per_warp; it0 < items; it0 += blockDim.x / ctt::kDmGroup) {
    const uint32_t it = it0 + lane / ctt::kDmGroup;
    uint32_t sum = ctt::rs_dm_partial(sh, lg_k, na, xor_const, it, lane % ctt::kDmGroup);
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 1);
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 2);
    if (lane % ctt::kDmGroup == 0) ctt::rs_dm_finish(sh, lg_k, na, it, sum);
  }
  __syncthreads();
  ctt::rs_dm_write(sh, D + a0 * 2 * k * k, lg_k, na, xor_const, tid, blockDim.x);
}

// blockIdx.y the axis, blockIdx.x the run of `gpb` output groups (8
// unknown positions each) the block decodes.
__global__ void __launch_bounds__(ctt::kGf2Threads, 1)
    rs_gf2_decode_kernel(uint8_t* eds, const uint8_t* D, const uint8_t* known, const int32_t* axes,
                         const uint8_t* gexp, const uint8_t* glog, uint32_t k, uint32_t gpb,
                         uint64_t as, uint64_t ps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const ctt::Gf2Smem sh(smem, k);
  __shared__ uint8_t kpos[kMaxK];
  __shared__ uint8_t opos[kMaxK];
  __shared__ uint32_t known_bits[2 * kMaxK / 32];
  __shared__ int out_of_range;
  const uint32_t tid = threadIdx.x, a = blockIdx.y;
  const int32_t axis = axes[a];
  if (tid < 2 * kMaxK / 32) known_bits[tid] = 0;
  if (tid == 0) out_of_range = axis < 0 || static_cast<uint32_t>(axis) >= 2 * k;
  ctt::gf2_load_tables(sh, gexp, glog);
  const uint8_t p = tid < k ? known[static_cast<uint64_t>(a) * k + tid] : 0;
  __syncthreads();
  ctt::gf2_build_products(sh);
  if (tid < k) {
    kpos[tid] = p;
    if (p < 2 * k)
      atomicOr(&known_bits[p / 32], 1u << (p % 32));
    else
      out_of_range = 1;
  }
  __syncthreads();
  if (out_of_range) return;  // the whole block: an axis or position past 2k is not decoded
  const uint32_t i0 = blockIdx.x * gpb * ctt::kGf2Outputs;
  const uint32_t n_out = k - i0 < gpb * ctt::kGf2Outputs ? k - i0 : gpb * ctt::kGf2Outputs;
  const uint32_t groups = (n_out + ctt::kGf2Outputs - 1) / ctt::kGf2Outputs;
  const ctt::Gf2DecodeAxes ax{eds + static_cast<uint32_t>(axis) * as, ps, kpos, opos + i0, n_out};
  uint32_t first[4][2];  // in flight through the rest of the prologue
  ctt::gf2_lane_chunk(ax, 0, k, 0, tid / 32, tid % 32, first);
  if (tid < 2 * k && !ctt::rs_is_known(known_bits, tid)) {
    const uint32_t r = ctt::rs_unknown_rank(known_bits, tid);
    if (r < k) opos[r] = static_cast<uint8_t>(tid);
  }
  __syncthreads();
  const uint8_t* Da = D + static_cast<uint64_t>(a) * 2 * k * k;
  uint32_t coef[ctt::kGf2ItemsPerThread];
  ctt::gf2_fetch_coef(groups, n_out, k,
                      [&](uint32_t o, uint32_t j) { return Da[opos[i0 + o] * k + j]; }, coef);
  ctt::gf2_expand(sh, groups, k, coef);
  __syncthreads();
  ctt::gf2_gemm(ax, groups, k, sh, first);
}

__global__ void rs_repair_verdicts_kernel(const uint8_t* repaired, const uint8_t* recomputed,
                                          const uint8_t* provided, const uint8_t* avail,
                                          uint8_t* mismatch, uint8_t* provided_mismatch,
                                          uint32_t cells) {
  const uint32_t warp = threadIdx.x / ctt::kVerdictLanes, lane = threadIdx.x % ctt::kVerdictLanes;
  const uint32_t cell = blockIdx.x * kVerdictCellsPerBlock + warp;
  if (cell >= cells) return;  // whole warps leave together
  const uint32_t bits = ctt::rs_verdict_lane(repaired, recomputed, provided, cell, lane);
  const unsigned any_rec = __any_sync(0xFFFFFFFFu, bits & 1u);
  const unsigned any_prov = __any_sync(0xFFFFFFFFu, bits & 2u);
  if (lane == 0) {
    mismatch[cell] = any_rec ? 1 : 0;
    provided_mismatch[cell] = (avail[cell] && any_prov) ? 1 : 0;
  }
}

}  // namespace

// known uint8[n, k] (distinct positions per axis) -> D uint8[n, 2k, k];
// gexp uint8[512] / glog uint8[256] the codec's tables; xor_const is k
// under leopard-ff8 (position -> point is XOR with k), 0 under
// lagrange-gf256.  k a power of two <= 128; D 16-byte aligned.
extern "C" int ctt_rs_decode_matrices(const void* known, void* D, const void* gexp,
                                      const void* glog, int n, int k, int xor_const,
                                      void* stream) {
  if (n <= 0) return 0;
  const uint32_t lg_k = ctt::log2_exact(static_cast<uint64_t>(k > 0 ? k : 0));
  if (lg_k > 7 || (reinterpret_cast<uintptr_t>(D) & 15u))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t apb = ctt::rs_dm_axes_per_block(static_cast<uint32_t>(n), static_cast<uint32_t>(k));
  const unsigned blocks = (static_cast<uint32_t>(n) + apb - 1) / apb;
  rs_decode_matrices_kernel<<<blocks, ctt::kDmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(known), static_cast<uint8_t*>(D),
      static_cast<const uint8_t*>(gexp), static_cast<const uint8_t*>(glog),
      static_cast<uint32_t>(n), lg_k, apb, static_cast<uint32_t>(xor_const));
  return static_cast<int>(cudaGetLastError());
}

// Decode axes axes[0..n) of one orientation of eds uint8[2k, 2k, 512] in
// place (cols = 0: rows, 1: columns): axis axes[a] from its known
// positions known[a] with D[a] (uint8[n, 2k, k], K8a's output).
extern "C" int ctt_rs_decode_axes(void* eds, const void* D, const void* known, const void* axes,
                                  const void* gexp, const void* glog, int n, int k, int cols,
                                  void* stream) {
  if (n <= 0) return 0;
  const uint64_t S = kShareBytes, n2 = 2 * static_cast<uint64_t>(k);
  const uint64_t as = cols ? S : n2 * S, ps = cols ? n2 * S : S;
  // the most any call asks (k = 128), as launch_encode raises it
  const cudaError_t err =
      ctt::raise_smem_once<rs_gf2_decode_kernel>(ctt::gf2_smem_bytes(kMaxK, ctt::kGf2MaxGroups));
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint32_t groups = (k + ctt::kGf2Outputs - 1) / ctt::kGf2Outputs;
  const uint32_t gpb = ctt::gf2_groups_per_block(groups, n);
  rs_gf2_decode_kernel<<<dim3((groups + gpb - 1) / gpb, n), ctt::kGf2Threads,
                         ctt::gf2_smem_bytes(k, gpb), static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(eds), static_cast<const uint8_t*>(D),
      static_cast<const uint8_t*>(known), static_cast<const int32_t*>(axes),
      static_cast<const uint8_t*>(gexp), static_cast<const uint8_t*>(glog), k, gpb, as, ps);
  return static_cast<int>(cudaGetLastError());
}

// The verdicts of `cells` 512-byte cells: mismatch[c] = repaired[c] !=
// recomputed[c]; provided_mismatch[c] = avail[c] && repaired[c] !=
// provided[c] (all uint8, the masks 0/1).
extern "C" int ctt_rs_repair_verdicts(const void* repaired, const void* recomputed,
                                      const void* provided, const void* avail, void* mismatch,
                                      void* provided_mismatch, int cells, void* stream) {
  if (cells <= 0) return 0;
  const unsigned blocks = (cells + kVerdictCellsPerBlock - 1) / kVerdictCellsPerBlock;
  rs_repair_verdicts_kernel<<<blocks, kVerdictCellsPerBlock * ctt::kVerdictLanes, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(repaired), static_cast<const uint8_t*>(recomputed),
      static_cast<const uint8_t*>(provided), static_cast<const uint8_t*>(avail),
      static_cast<uint8_t*>(mismatch), static_cast<uint8_t*>(provided_mismatch), cells);
  return static_cast<int>(cudaGetLastError());
}
