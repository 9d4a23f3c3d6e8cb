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
// Bound on the H100 (k = 128): K8b does k * k multiply-adds per output
// share byte, 2.1 G for the 256 axes of a 25 % mask, against 64 MiB of
// traffic; K8a is k^2 table lookups per output row (small); K8c reads three
// 32 MiB squares.
// Design (the simple form):
// - K8a: one block per axis, one thread per output row; the k source
//   points and their denominators are staged in shared memory first.
// - K8b: K5's axis body (rs_extend.cuh) with a per-axis D and a per-axis
//   list of known positions, reading the EDS in place through strides
//   (rows or columns); a block writes 8 of the axis's k unknown positions.
//   Only the solvable axes are launched and only unknown positions are
//   written (rs_decode.cuh), which is byte-identical to the JAX program's
//   decode-everything-then-mask.
// - K8c: one warp per cell, 16-byte loads, warp vote into two byte masks.
#include <cuda_runtime.h>

#include "rs_decode.cuh"

namespace {

constexpr uint32_t kMaxK = 128;
constexpr uint32_t kShareBytes = 512;
constexpr uint32_t kThreads = kShareBytes / 4;  // one 4-byte slice each
constexpr uint32_t kVerdictCellsPerBlock = 8;

__global__ void rs_decode_matrices_kernel(const uint8_t* known, uint8_t* D,
                                          const uint8_t* gexp_g, const uint8_t* glog_g,
                                          uint32_t k, uint32_t xor_const) {
  __shared__ uint8_t exp_s[256];
  __shared__ uint8_t log_s[256];
  __shared__ uint8_t src[kMaxK];
  __shared__ uint16_t denom[kMaxK];
  const uint32_t tid = threadIdx.x, a = blockIdx.x;
  for (uint32_t v = tid; v < 256u; v += blockDim.x) {
    exp_s[v] = gexp_g[v];
    log_s[v] = glog_g[v];
  }
  for (uint32_t j = tid; j < k; j += blockDim.x)
    src[j] = static_cast<uint8_t>(known[static_cast<uint64_t>(a) * k + j] ^ xor_const);
  __syncthreads();
  for (uint32_t j = tid; j < k; j += blockDim.x)
    denom[j] = static_cast<uint16_t>(ctt::rs_denom_log(src, k, j, log_s));
  __syncthreads();
  for (uint32_t i = tid; i < 2 * k; i += blockDim.x)
    ctt::rs_decode_row(src, denom, k, i ^ xor_const, exp_s, log_s,
                       D + (static_cast<uint64_t>(a) * 2 * k + i) * k);
}

__global__ void rs_decode_axes_kernel(uint8_t* eds, const uint8_t* D, const uint8_t* known,
                                      const int32_t* axes, const uint8_t* gexp_g,
                                      const uint8_t* glog_g, uint32_t k, uint64_t as,
                                      uint64_t ps) {
  __shared__ uint8_t exp_t[ctt::kExpEntries];
  __shared__ uint16_t log_t[256];
  __shared__ uint16_t logD[ctt::kRsOutPerBlock * kMaxK];
  __shared__ uint8_t kpos[kMaxK];
  __shared__ uint8_t opos[kMaxK];
  __shared__ bool in_bounds;
  const uint32_t tid = threadIdx.x, a = blockIdx.y;
  const uint8_t* kn = known + static_cast<uint64_t>(a) * k;
  for (uint32_t i = tid; i < ctt::kExpEntries; i += blockDim.x)
    exp_t[i] = ctt::rs_exp_entry(gexp_g, i);
  for (uint32_t v = tid; v < 256u; v += blockDim.x) log_t[v] = ctt::rs_log_entry(glog_g, v);
  for (uint32_t j = tid; j < k; j += blockDim.x) kpos[j] = kn[j];
  if (tid == 0) {
    ctt::rs_unknown_positions(kn, k, opos);
    in_bounds = ctt::rs_axis_in_bounds(kn, k, axes[a]);
  }
  __syncthreads();
  if (!in_bounds) return;  // the whole block: an axis or position past 2k is not decoded
  const uint32_t i0 = blockIdx.x * ctt::kRsOutPerBlock;
  const uint32_t nout = k - i0 < ctt::kRsOutPerBlock ? k - i0 : ctt::kRsOutPerBlock;
  const uint8_t* Da = D + static_cast<uint64_t>(a) * 2 * k * k;
  for (uint32_t idx = tid; idx < nout * k; idx += blockDim.x)
    logD[idx] = ctt::rs_log_entry(glog_g, Da[opos[i0 + idx / k] * k + idx % k]);
  __syncthreads();
  ctt::rs_decode_body(eds, logD, kpos, opos + i0, nout, k, as, ps,
                      static_cast<uint32_t>(axes[a]), tid, exp_t, log_t);
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
// lagrange-gf256.
extern "C" int ctt_rs_decode_matrices(const void* known, void* D, const void* gexp,
                                      const void* glog, int n, int k, int xor_const,
                                      void* stream) {
  if (n <= 0) return 0;
  const unsigned threads = static_cast<unsigned>(2 * k);
  rs_decode_matrices_kernel<<<n, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(known), static_cast<uint8_t*>(D),
      static_cast<const uint8_t*>(gexp), static_cast<const uint8_t*>(glog), k, xor_const);
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
  const unsigned chunks = (k + ctt::kRsOutPerBlock - 1) / ctt::kRsOutPerBlock;
  rs_decode_axes_kernel<<<dim3(chunks, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(eds), static_cast<const uint8_t*>(D),
      static_cast<const uint8_t*>(known), static_cast<const int32_t*>(axes),
      static_cast<const uint8_t*>(gexp), static_cast<const uint8_t*>(glog), k, as, ps);
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
