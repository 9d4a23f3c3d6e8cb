// K5 `rs_extend`, K5b `rs_extend_batched` and K5's row pass under the
// leopard-ff8 codec: the 2D Reed-Solomon extension in Leopard's O(k log k)
// form (rs_leopard.cuh).  Under lagrange-gf256 the same three entry points
// run the bit-GEMM kernel of rs_extend.cu; the codec alone picks the
// kernel (celestia_tpu_torch/ops/rs.py).
//
// Replaces: celestia_tpu/ops/rs.py:64 `_extend` (entry `extend_square`
// :82) and :102 `_extend_batched_fn` (entry `extend_squares_batched`
// :107), the JAX package's bit-lifted GEMM, 2 * 8k * 8k * 3k * 512 int8
// operations a square (412 G at k = 128).  Here a square is 3k axis
// encodes of 2 * (k/2) * log2 k butterflies a byte position (896 at k =
// 128, against the GEMM's k^2 = 16,384 multiply-adds).
//
// Bound on the H100 at k = 128: bytes, Q0 read and the EDS written
// (~40 MiB, 0.0125 ms at 3.35 TB/s); the least-work operations
// (devprof.leopard_extend_ops) take 0.0079 ms.
//
// Design: two threads a 4-byte word column of one axis (lanes l and l + 16
// of a warp), k/2 words each in registers for all 2 log2 k layers (the
// kernel is templated on log2 k, 0..7, so the layers unroll with constant
// indices); the two layers that pair the halves are one cross step, one
// shuffle a word (rs_leopard.cuh).  Each input byte is read from HBM once
// and each parity byte written once.  A half-warp covers 64 bytes of a
// share, so each warp load or store is two 64-byte runs (whole sectors,
// whatever the axis's stride): per-thread 16-byte loads would buy no
// bandwidth and cost 4x the registers.  A block is one warp, 16 columns,
// so a launch has 8 blocks an axis (3k axes a square) and at k = 64 and
// 128 the grid covers all 132 SMs.  A block stages the encode's skew
// tables (6 words a group, 2(k - 1) groups, 6 KiB at k = 128) in shared
// memory.  The multiply (rs_leopard.cuh leo_mul_word) is three byte
// permutes: ~16 SASS operations a word of 4 bytes (4 PRMT, 3 LEA, 2 SHF,
// ~7 LOP3), ~4 a byte.  A bit-sliced 8 x 8 GF(2) matrix would take ~2 a
// byte (8 masked XORs a bit plane of 32 bytes), but a thread would hold
// 32 bytes of each share -- 8x the registers of a column, which at k >=
// 32 do not fit -- and it needs 64 masks a skew and a bit transpose at
// each load and store, so the byte permutes are kept.  On an H100 (CUDA
// 12.8) the k = 128 instance takes 128 registers, no spill, 8,832 SASS
// instructions a thread (34.5 a parity byte over a column's two threads);
// chip_smoke.py prints its registers, spills and SASS opcode mix.  It is
// bounded by integer issue (~0.052 ms a square at the card's 16.7 T int32
// operations a second), not by its bytes.
// Launch 1 computes Q1 (the rows' parity) and Q2 (the columns' parity) of
// Q0, blockIdx.z picking the stride set; launch 2 Q3 from Q1's columns; Q0
// is one 2D device copy.  Batched, the same two launches over n squares
// (blockIdx.z = square * sets + set).  The row pass is launch 1's row set
// over n row axes.  All on the caller's stream.
#include <cuda_runtime.h>

#include "rs_leopard.cuh"

namespace {

constexpr uint32_t kShareBytes = ctt::kLeoShare;
constexpr uint32_t kWarp = 32;

constexpr uint32_t kColumns = kWarp / 2;  // word columns a warp

// blockIdx.x: the warp's 16 word columns of the axis; blockIdx.y: the axis;
// blockIdx.z = b * nsets + set: stride set `set` of square b, whose input
// and output lie ibs and obs bytes after square 0's.  Lane l holds half
// l / 16 of column l % 16.
template <uint32_t LOG_K>
__global__ void __launch_bounds__(kWarp)
    rs_leopard_kernel(ctt::LeoAxisSet s0, ctt::LeoAxisSet s1, const uint32_t* tab, uint32_t nsets,
                      uint64_t ibs, uint64_t obs) {
  constexpr uint32_t K = 1u << LOG_K;
  constexpr uint32_t kTabWords = ctt::kLeoGroupWords * (K > 1 ? 2 * (K - 1) : 1);
  __shared__ __align__(16) uint32_t sh[kTabWords];
  if (K > 1)
    for (uint32_t i = threadIdx.x; i < kTabWords; i += kWarp) sh[i] = tab[i];
  __syncthreads();
  const ctt::LeoAxisSet s = blockIdx.z % nsets ? s1 : s0;
  const uint64_t b = blockIdx.z / nsets;
  const uint32_t h = threadIdx.x / kColumns;
  const uint64_t word = 4ull * (blockIdx.x * kColumns + threadIdx.x % kColumns);
  const uint8_t* in = s.in + b * ibs + blockIdx.y * s.as + word;
  uint8_t* out = s.out + b * obs + blockIdx.y * s.oas + word;
  if constexpr (LOG_K == 0) {  // the parity of one share is the share
    if (h == 0) *reinterpret_cast<uint32_t*>(out) = *reinterpret_cast<const uint32_t*>(in);
  } else {
    uint32_t x[K / 2], t[5];
    ctt::leo_half_load<LOG_K>(in, s.ps, h, x);
    ctt::leo_half_ifft<LOG_K>(x, sh, h);
    ctt::leo_load_group(ctt::leo_cross_group(sh, K), t);
#pragma unroll
    for (uint32_t i = 0; i < K / 2; ++i)
      x[i] = ctt::leo_cross_word(x[i], __shfl_xor_sync(0xFFFFFFFFu, x[i], kColumns), t);
    ctt::leo_half_fft<LOG_K>(x, sh, h);
    ctt::leo_half_store<LOG_K>(out, s.ops, h, x);
  }
}

template <uint32_t LOG_K>
cudaError_t launch_k(const ctt::LeoAxisSet& s0, const ctt::LeoAxisSet& s1, const uint32_t* tab,
                     uint32_t n_axes, uint32_t nsets, uint32_t nz, uint64_t ibs, uint64_t obs,
                     cudaStream_t st) {
  rs_leopard_kernel<LOG_K><<<dim3(ctt::kLeoWords / kColumns, n_axes, nz), kWarp, 0, st>>>(
      s0, s1, tab, nsets, ibs, obs);
  return cudaGetLastError();
}

// One launch: the parity of n_axes axes of each of nz (square, set) pairs.
int launch_encode(const ctt::LeoAxisSet& s0, const ctt::LeoAxisSet& s1, const void* tab, int k,
                  uint32_t n_axes, uint32_t nsets, uint32_t nz, uint64_t ibs, uint64_t obs,
                  cudaStream_t st) {
  const uint32_t* t = static_cast<const uint32_t*>(tab);
  switch (ctt::log2_exact(static_cast<uint64_t>(k))) {
    case 0: return launch_k<0>(s0, s1, t, n_axes, nsets, nz, ibs, obs, st);
    case 1: return launch_k<1>(s0, s1, t, n_axes, nsets, nz, ibs, obs, st);
    case 2: return launch_k<2>(s0, s1, t, n_axes, nsets, nz, ibs, obs, st);
    case 3: return launch_k<3>(s0, s1, t, n_axes, nsets, nz, ibs, obs, st);
    case 4: return launch_k<4>(s0, s1, t, n_axes, nsets, nz, ibs, obs, st);
    case 5: return launch_k<5>(s0, s1, t, n_axes, nsets, nz, ibs, obs, st);
    case 6: return launch_k<6>(s0, s1, t, n_axes, nsets, nz, ibs, obs, st);
    case 7: return launch_k<7>(s0, s1, t, n_axes, nsets, nz, ibs, obs, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad_k(int k) { return k < 1 || ctt::log2_exact(static_cast<uint64_t>(k)) > ctt::kLeoMaxLogK; }

}  // namespace

// The skew tables of a k-share encode (ctt::leo_group_tables) from the
// codec's field tables gexp uint8[512], glog uint8[256], into out
// (out_bytes >= ctt::leo_table_bytes(k)).  Host memory; launches nothing.
extern "C" int ctt_rs_leopard_tables(const void* gexp, const void* glog, int k, void* out,
                                     long long out_bytes) {
  if (bad_k(k) || out_bytes < static_cast<long long>(ctt::leo_table_bytes(uint32_t(k))))
    return static_cast<int>(cudaErrorInvalidValue);
  ctt::leo_group_tables(static_cast<const uint8_t*>(gexp), static_cast<const uint8_t*>(glog),
                        uint32_t(k), static_cast<uint32_t*>(out));
  return 0;
}

// squares uint8[n, k, k, 512] -> eds uint8[n, 2k, 2k, 512] in two launches
// for the batch; tab: the tables of ctt_rs_leopard_tables, on the card.
extern "C" int ctt_rs_leopard_extend_batched(const void* squares, void* eds, const void* tab,
                                             int k, int n, void* stream) {
  if (bad_k(k) || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t S = kShareBytes, K = static_cast<uint64_t>(k);
  const uint64_t sq_bytes = K * K * S, eds_bytes = 4 * K * K * S;
  const uint8_t* q0 = static_cast<const uint8_t*>(squares);
  uint8_t* out = static_cast<uint8_t*>(eds);
  for (int b = 0; b < n; ++b) {
    const cudaError_t err = cudaMemcpy2DAsync(out + b * eds_bytes, 2 * K * S, q0 + b * sq_bytes,
                                              K * S, K * S, K, cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  uint8_t* q1 = out + K * S;
  uint8_t* q2 = out + K * 2 * K * S;
  uint8_t* q3 = q2 + K * S;
  const ctt::LeoAxisSet rows{q0, q1, K * S, S, 2 * K * S, S};
  const ctt::LeoAxisSet cols{q0, q2, S, K * S, S, 2 * K * S};
  const int err = launch_encode(rows, cols, tab, k, uint32_t(k), 2, 2 * uint32_t(n), sq_bytes,
                                eds_bytes, st);
  if (err != 0) return err;
  const ctt::LeoAxisSet q1cols{q1, q3, S, 2 * K * S, S, 2 * K * S};
  return launch_encode(q1cols, q1cols, tab, k, uint32_t(k), 1, uint32_t(n), eds_bytes, eds_bytes,
                       st);
}

// square uint8[k, k, 512] -> eds uint8[2k, 2k, 512]: the batch of one.
extern "C" int ctt_rs_leopard_extend(const void* square, void* eds, const void* tab, int k,
                                     void* stream) {
  return ctt_rs_leopard_extend_batched(square, eds, tab, k, 1, stream);
}

// rows uint8[n, k, 512] -> out uint8[n, 2k, 512]: each row followed by its
// parity, one 2D copy and one launch (n <= 65535).
extern "C" int ctt_rs_leopard_extend_rows(const void* rows, void* out, const void* tab, int k,
                                          int n, void* stream) {
  if (bad_k(k) || n < 0 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t S = kShareBytes, K = static_cast<uint64_t>(k);
  const uint8_t* in = static_cast<const uint8_t*>(rows);
  uint8_t* o = static_cast<uint8_t*>(out);
  const cudaError_t err =
      cudaMemcpy2DAsync(o, 2 * K * S, in, K * S, K * S, n, cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ctt::LeoAxisSet set{in, o + K * S, K * S, S, 2 * K * S, S};
  return launch_encode(set, set, tab, k, uint32_t(n), 1, 1, 0, 0, st);
}
