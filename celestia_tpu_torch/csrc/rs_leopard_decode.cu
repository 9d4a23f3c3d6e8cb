// K8b `rs_decode_axes` under the leopard-ff8 codec: the erasure decode of
// the repair and of fraud detection in Leopard's O(k log k) form
// (rs_leopard_decode.cuh).  Under lagrange-gf256 the same kernel name runs
// the bit-GEMM of rs_decode.cu with K8a's Lagrange matrices; the codec
// alone picks the kernel (celestia_tpu_torch/ops/rs.py), and under
// leopard-ff8 no decode matrix is built (no K8a launch).
//
// Replaces: celestia_tpu/ops/rs.py:206 `_decode_axes_dev` with its GF(2)
// lift (:191, :179) and the masked writes of :234 `_repair_phases`, which
// the JAX package computes with K8a's matrices (:150): 2 * 8k * 8k * 512
// int8 operations an axis.  Here an axis is an IFFT and an FFT over its 2k
// positions, a formal derivative and two scalings: 3,840 GF(256) multiplies
// a byte position at k = 128, four bytes to a multiply (the bit-GEMM: k
// erased rows x k known columns = 16,384 products of 8 x 8 bits).
//
// Bound on the H100 at k = 128, the 256 rows of a 25 % mask: bytes, the k
// known cells read and the k erased ones written per axis (~33.6 MB, 0.0100
// ms at 3.35 TB/s) under the least-work operations (devprof.leopard_decode_ops,
// the two transforms at 3 operations a butterfly word: 0.0120 ms at 16.7 T
// int32 operations a second).
//
// Design: 2^C threads a 4-byte word column (lanes l + (32 >> C) t of a
// warp), n/2^C words each in registers; the kernel is templated on log2 2k
// (1..8) and C, so every layer unrolls with constant register indices.
// The C layers of each transform that pair threads, and the derivative's C
// levels of those bits, are one shuffle a word each (rs_leopard_decode.cuh).
// A launch of 66 axes or more runs 8 warps a block and at most 32 words a
// thread (C = 3 at k = 128, 2 below: 2 blocks an axis; 64 words a thread
// spilled); fewer axes -- the deep peel's one- and two-axis phases -- run
// 4 warps a block and C = 4 (16 blocks an axis), or 5 for at most 8 axes,
// so that a phase waits for less of a column's work.  A block's prologue
// computes its axis's locator (k^2 * 2 table lookups) and stages the
// per-position tables and the host's skew tables in shared memory (13 KiB),
// each laid out so that a column's threads read distinct banks; the skew
// tables are read anew at each use (volatile loads), which kept the k =
// 128 instance at 128 registers without a spill.  Only the k erased
// positions are written, so an axis's blocks never race and the known
// cells stay as they are; an axis whose index or a known position lies
// past 2k, or whose known positions repeat, is left as it is.  The
// multiply is K5's three byte permutes (rs_leopard.cuh leo_mul_word).
// chip_smoke.py prints the k = 128 instances' registers, spills and SASS
// opcode mix.  All on the caller's stream, one launch a call.
#include <cuda_runtime.h>

#include "rs_leopard_decode.cuh"

namespace {

constexpr uint32_t kShareBytes = ctt::kLeoShare;
constexpr uint32_t kWarp = 32;
constexpr uint32_t kMaxThreads = 8 * kWarp;

template <uint32_t LOG_N, uint32_t C, uint32_t M = 0>
__device__ __forceinline__ void deriv(ctt::LeoDecWords<LOG_N, C>& x, const uint32_t* tab,
                                      uint32_t t) {
  using D = ctt::LeoDec<LOG_N, C>;
  if constexpr (M < D::W) {
    uint32_t peer[C];
#pragma unroll
    for (uint32_t b = 0; b < C; ++b) peer[b] = __shfl_xor_sync(0xFFFFFFFFu, x[M], D::LANES << b);
    x[M] = ctt::leo_dec_deriv_word<LOG_N, C, M>(x, tab, peer, t);
    deriv<LOG_N, C, M + 1>(x, tab, t);
  }
}

// One word column, thread t of its 2^C.
template <uint32_t LOG_N, uint32_t C>
__device__ __forceinline__ void column(uint8_t* col, uint64_t ps, const ctt::LeoDecSmem& sh,
                                       uint32_t t) {
  using D = ctt::LeoDec<LOG_N, C>;
  uint32_t x[D::W], tt[5];
  ctt::leo_dec_load<LOG_N, C>(col, ps, sh.pos, t, x);
  ctt::leo_dec_ifft_local<LOG_N, C>(x, sh.tab, t);
#pragma unroll
  for (uint32_t b = 0; b < C; ++b) {
    const bool b_side = (t >> b) & 1u;
    if (b + 1 < C) ctt::leo_load_group_fresh(ctt::leo_dec_cross_group<LOG_N, C>(sh.tab, b, t), tt);
#pragma unroll
    for (uint32_t i = 0; i < D::W; ++i) {
      const uint32_t peer = __shfl_xor_sync(0xFFFFFFFFu, x[i], D::LANES << b);
      x[i] = b + 1 < C ? ctt::leo_dec_ifft_cross(x[i], peer, tt, b_side)
                       : ctt::leo_dec_top(x[i], peer, b_side);
    }
  }
  deriv<LOG_N, C>(x, sh.tab, t);
#pragma unroll
  for (uint32_t bb = C; bb > 0; --bb) {
    const uint32_t b = bb - 1;
    const bool b_side = (t >> b) & 1u;
    if (b + 1 < C) ctt::leo_load_group_fresh(ctt::leo_dec_cross_group<LOG_N, C>(sh.tab, b, t), tt);
#pragma unroll
    for (uint32_t i = 0; i < D::W; ++i) {
      const uint32_t peer = __shfl_xor_sync(0xFFFFFFFFu, x[i], D::LANES << b);
      x[i] = b + 1 < C ? ctt::leo_dec_fft_cross(x[i], peer, tt, b_side)
                       : ctt::leo_dec_top(x[i], peer, b_side);
    }
  }
  ctt::leo_dec_fft_local<LOG_N, C>(x, sh.tab, t);
  ctt::leo_dec_store<LOG_N, C>(col, ps, sh.pos, t, x);
}

// blockIdx.y: the axis (axes[blockIdx.y]); blockIdx.x: the block's run of
// blockDim.x / 2^C word columns.  Lane l is thread t = l / (32 >> C) of
// column l % (32 >> C) of its warp.
template <uint32_t LOG_N, uint32_t C>
__global__ void __launch_bounds__(kMaxThreads, 2)
    rs_leopard_decode_kernel(uint8_t* eds, const uint8_t* known, const int32_t* axes,
                             const uint32_t* tab, const uint8_t* gexp, const uint8_t* glog,
                             uint64_t as, uint64_t ps) {
  constexpr uint32_t K = (1u << LOG_N) / 2, LANES = kWarp >> C;
  __shared__ __align__(16) ctt::LeoDecSmem sh;
  const uint32_t tid = threadIdx.x, nt = blockDim.x, a = blockIdx.y;
  const int32_t axis = axes[a];
  ctt::leo_dec_stage(sh, tab, gexp, glog, K, C, axis, tid, nt);
  __syncthreads();
  ctt::leo_dec_mark(sh, known + static_cast<uint64_t>(a) * K, K, tid, nt);
  __syncthreads();
  ctt::leo_dec_list(sh, K, tid, nt);
  __syncthreads();
  if (ctt::leo_dec_skip(sh, K)) return;  // the whole block
  ctt::leo_dec_scales(sh, K, C, tid, nt);
  __syncthreads();
  const uint32_t lane = tid % kWarp, t = lane / LANES;
  const uint32_t c = blockIdx.x * (nt >> C) + (tid / kWarp) * LANES + lane % LANES;
  uint8_t* col = eds + static_cast<uint32_t>(axis) * as + 4ull * c;
  if constexpr (LOG_N == 1) {
    if (t == 0) ctt::leo_dec_one(col, ps, sh);
  } else {
    column<LOG_N, C>(col, ps, sh, t);
  }
}

struct Launch {
  uint8_t* eds;
  const uint8_t* known;
  const int32_t* axes;
  const uint32_t* tab;
  const uint8_t* gexp;
  const uint8_t* glog;
  uint32_t n_axes;
  uint64_t as, ps;
  cudaStream_t st;
};

template <uint32_t LOG_N, uint32_t C>
cudaError_t launch_n(const Launch& l) {
  const uint32_t warps = ctt::leo_dec_warps(l.n_axes), columns = warps * (kWarp >> C);
  rs_leopard_decode_kernel<LOG_N, C><<<dim3(ctt::kLeoWords / columns, l.n_axes), warps * kWarp,
                                       0, l.st>>>(l.eds, l.known, l.axes, l.tab, l.gexp, l.glog,
                                                  l.as, l.ps);
  return cudaGetLastError();
}

// 2^C threads a column as leo_dec_log_threads asks: one of three shapes a k.
template <uint32_t LOG_N>
cudaError_t launch_k(const Launch& l) {
  constexpr uint32_t many = ctt::leo_dec_log_threads(ctt::kLeoDecManyAxes, LOG_N);
  constexpr uint32_t some = ctt::leo_dec_log_threads(ctt::kLeoDecFewAxes + 1, LOG_N);
  constexpr uint32_t few = ctt::leo_dec_log_threads(1, LOG_N);
  const uint32_t c = ctt::leo_dec_log_threads(l.n_axes, LOG_N);
  return c == many ? launch_n<LOG_N, many>(l)
                   : (c == some ? launch_n<LOG_N, some>(l) : launch_n<LOG_N, few>(l));
}

bool bad_k(int k) { return k < 1 || ctt::log2_exact(static_cast<uint64_t>(k)) > ctt::kLeoMaxLogK; }

}  // namespace

// The tables of a k-share axis's decode (ctt::leo_decode_tables) from the
// codec's field tables gexp uint8[512], glog uint8[256], into out
// (out_bytes >= ctt::leo_dec_table_bytes(k)).  Host memory; launches
// nothing.
extern "C" int ctt_rs_leopard_decode_tables(const void* gexp, const void* glog, int k, void* out,
                                            long long out_bytes) {
  if (bad_k(k) || out_bytes < static_cast<long long>(ctt::leo_dec_table_bytes(uint32_t(k))))
    return static_cast<int>(cudaErrorInvalidValue);
  ctt::leo_decode_tables(static_cast<const uint8_t*>(gexp), static_cast<const uint8_t*>(glog),
                         uint32_t(k), static_cast<uint32_t*>(out));
  return 0;
}

// Decode axes axes[0..n) of one orientation of eds uint8[2k, 2k, 512] in
// place (cols = 0: rows, 1: columns): axis axes[a] from its k known
// positions known[a] (uint8[n, k]), every other position written.  tab:
// ctt_rs_leopard_decode_tables's on the card; gexp / glog the codec's
// field tables on the card.  n <= 65535.
extern "C" int ctt_rs_leopard_decode_axes(void* eds, const void* known, const void* axes,
                                          const void* tab, const void* gexp, const void* glog,
                                          int n, int k, int cols, void* stream) {
  if (bad_k(k) || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const uint64_t S = kShareBytes, n2 = 2 * static_cast<uint64_t>(k);
  const uint64_t as = cols ? S : n2 * S, ps = cols ? n2 * S : S;
  const Launch l{static_cast<uint8_t*>(eds), static_cast<const uint8_t*>(known),
                 static_cast<const int32_t*>(axes), static_cast<const uint32_t*>(tab),
                 static_cast<const uint8_t*>(gexp), static_cast<const uint8_t*>(glog),
                 static_cast<uint32_t>(n), as, ps, static_cast<cudaStream_t>(stream)};
  switch (ctt::log2_exact(n2)) {
    case 1: return static_cast<int>(launch_k<1>(l));
    case 2: return static_cast<int>(launch_k<2>(l));
    case 3: return static_cast<int>(launch_k<3>(l));
    case 4: return static_cast<int>(launch_k<4>(l));
    case 5: return static_cast<int>(launch_k<5>(l));
    case 6: return static_cast<int>(launch_k<6>(l));
    case 7: return static_cast<int>(launch_k<7>(l));
    case 8: return static_cast<int>(launch_k<8>(l));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
