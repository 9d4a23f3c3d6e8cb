// K9a `rs_col_parity_partial` under the leopard-ff8 codec: a row shard's
// column-parity partial in Leopard's O(k log k) form, with the shard's zero
// inputs pruned (rs_leopard.cuh, "K9a under leopard-ff8").  Under
// lagrange-gf256 K9a runs the bit-GEMM of rs_extend.cu; the codec alone
// picks the kernel (celestia_tpu_torch/ops/rs.py).
//
// Replaces: celestia_tpu/parallel/sharded.py:78-87, the `g_cols` dynamic
// slice of the bit-expanded encode matrix and the int32 matmul of a
// shard's bit planes, (G[:, 8 j0 : 8 (j0 + m)] @ bits) & 1, packed.  A
// shard holding rows j0 .. j0 + m - 1 (m = k/R) and their row parity, top
// uint8[n, m, 2k, 512], writes partial uint8[n, k, 2k, 512]: for each of
// the 2k column codewords the k parity values of Leopard's encode of that
// column with the other k - m data rows zero.  The R partials XOR to the
// parity rows (K9b, rs_sharded.cu).
//
// Bound on the H100 at k = 128, R = 8 (the 8 shards): bytes, the top rows
// read once (16 MiB) and the partials written once (128 MiB), 0.0451 ms at
// 3.35 TB/s; the pruned transforms' operations (devprof.leopard_partial_ops)
// take less.  The work: per column codeword (m/2) log2 m butterflies in the
// block, k - m one-operand ones spreading it, and K5's FFT's (k/2) log2 k:
// 592 word multiplies at m = 16 against a full encode's 896.
//
// Design: K5's (rs_leopard.cu): a block is one warp, 16 word columns of one
// column codeword (blockIdx.x) of one square (blockIdx.z), two threads a
// column (lanes l and l + 16), the layers unrolled over registers (the
// kernel is templated on log2 k and log2 m), the multiply three byte
// permutes, the launch's skew tables (its shard's own: leo_partial_tables)
// staged in shared memory.  Both threads of a column load the shard's m
// words (one 64-byte run a warp load) and run the block's IFFT and its
// spread to k/2 words alike, so no lane idles and nothing is exchanged;
// the top step leaves each thread K5's half of the column, whose FFT it
// runs and stores as 4-byte words (two 64-byte runs a warp store).  m = k
// is K5's encode with its cross-step shuffle.  At m < k the block's IFFT
// and spread are run twice, by both threads of a column: splitting them
// would save at most (m/2) log2 m / 2 + (k/2 - m) / 2 multiplies a thread
// (40 of 336 at k = 128, m = 16) and cost the k/2-word exchange that the
// top step then needs.  Each top row byte is read once by a warp and each
// partial byte written once.
#include <cuda_runtime.h>

#include "rs_leopard.cuh"

namespace {

constexpr uint32_t kShareBytes = ctt::kLeoShare;
constexpr uint32_t kWarp = 32;
constexpr uint32_t kColumns = kWarp / 2;  // word columns a warp
constexpr uint32_t kMaxBatch = 65535;     // gridDim.z
// One-warp blocks an SM the register budget must allow: 16, 128 registers
// a thread (the m = k instance, K5's encode, takes more without it), but
// for m = k/2, whose block's IFFT holds the whole half and spills under
// that bound: it takes what it needs.
constexpr uint32_t min_blocks(uint32_t log_k, uint32_t log_m) {
  return log_m + 1 == log_k ? 1 : 16;
}

// blockIdx.x: the warp's 16 word columns; blockIdx.y: the column codeword
// (0 .. 2k - 1); blockIdx.z: the square.  Lane l holds half l / 16 of
// column l % 16.  A row of the top and of the partial is 2k shares.
template <uint32_t LOG_K, uint32_t LOG_M>
__global__ void __launch_bounds__(kWarp, min_blocks(LOG_K, LOG_M))
    rs_leopard_partial_kernel(const uint8_t* top, uint8_t* partial, const uint32_t* tab,
                              uint32_t j0) {
  constexpr uint32_t K = 1u << LOG_K, M = 1u << LOG_M;
  constexpr uint32_t kGroups = K > 1 ? (M - 1) + (LOG_K - LOG_M) + (K - 1) : 1;
  constexpr uint32_t kTabWords = ctt::kLeoGroupWords * kGroups;
  __shared__ __align__(16) uint32_t sh[kTabWords];
  if (K > 1)
    for (uint32_t i = threadIdx.x; i < kTabWords; i += kWarp) sh[i] = tab[i];
  __syncthreads();
  const uint64_t row = 2ull * K * kShareBytes;
  const uint32_t h = threadIdx.x / kColumns;
  const uint64_t word = 4ull * (blockIdx.x * kColumns + threadIdx.x % kColumns);
  const uint8_t* in = top + blockIdx.z * M * row + blockIdx.y * kShareBytes + word;
  uint8_t* out = partial + blockIdx.z * K * row + blockIdx.y * kShareBytes + word;
  if constexpr (LOG_K == 0) {  // the parity of one share is the share
    if (h == 0) *reinterpret_cast<uint32_t*>(out) = *reinterpret_cast<const uint32_t*>(in);
  } else {
    uint32_t x[K / 2];
    if constexpr (LOG_M == LOG_K) {  // the whole column: K5's encode
      uint32_t t[5];
      ctt::leo_half_load<LOG_K>(in, row, h, x);
      ctt::leo_half_ifft<LOG_K>(x, sh, h);
      ctt::leo_load_group(ctt::leo_cross_group(sh, K), t);
#pragma unroll
      for (uint32_t i = 0; i < K / 2; ++i)
        x[i] = ctt::leo_cross_word(x[i], __shfl_xor_sync(0xFFFFFFFFu, x[i], kColumns), t);
    } else {
      ctt::leo_partial_ifft<LOG_K, LOG_M>(in, row, sh, j0, h, x);
    }
    ctt::leo_half_fft_at<LOG_K>(x, sh + ctt::kLeoGroupWords * ctt::leo_partial_fft_group(K, M),
                                h);
    ctt::leo_half_store<LOG_K>(out, row, h, x);
  }
}

// The instance of log2 k = LOG_K and log2 m = log_m.
template <uint32_t LOG_K, uint32_t LOG_M = 0>
cudaError_t launch_m(uint32_t log_m, const uint8_t* top, uint8_t* partial, const uint32_t* tab,
                     uint32_t j0, uint32_t n, cudaStream_t st) {
  if constexpr (LOG_M > LOG_K) {
    return cudaErrorInvalidValue;
  } else {
    if (log_m != LOG_M) return launch_m<LOG_K, LOG_M + 1>(log_m, top, partial, tab, j0, n, st);
    rs_leopard_partial_kernel<LOG_K, LOG_M>
        <<<dim3(ctt::kLeoWords / kColumns, 2u << LOG_K, n), kWarp, 0, st>>>(top, partial, tab,
                                                                             j0);
    return cudaGetLastError();
  }
}

}  // namespace

// The skew tables of the partial of the shard holding rows j0 .. j0 + m - 1
// of k (ctt::leo_partial_tables) from the codec's field tables gexp
// uint8[512], glog uint8[256], into out (out_bytes >=
// ctt::leo_partial_table_bytes(k, m)).  Host memory; launches nothing.
extern "C" int ctt_rs_leopard_partial_tables(const void* gexp, const void* glog, int k, int m,
                                             int j0, void* out, long long out_bytes) {
  if (ctt::leo_partial_bad_shard(k, m, j0) ||
      out_bytes < static_cast<long long>(ctt::leo_partial_table_bytes(uint32_t(k), uint32_t(m))))
    return static_cast<int>(cudaErrorInvalidValue);
  ctt::leo_partial_tables(static_cast<const uint8_t*>(gexp), static_cast<const uint8_t*>(glog),
                          uint32_t(k), uint32_t(m), uint32_t(j0), static_cast<uint32_t*>(out));
  return 0;
}

// K9a: top uint8[n, m, 2k, 512] (each square's m rows of the shard at j0:
// Q0 | Q1) -> partial uint8[n, k, 2k, 512]; tab: the shard's tables of
// ctt_rs_leopard_partial_tables, on the card.  One launch (n <= 65535).
extern "C" int ctt_rs_leopard_col_parity_partial(const void* top, void* partial, const void* tab,
                                                 int k, int m, int j0, int n, void* stream) {
  if (ctt::leo_partial_bad_shard(k, m, j0) || n < 0 || uint32_t(n) > kMaxBatch)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const uint8_t* t = static_cast<const uint8_t*>(top);
  uint8_t* p = static_cast<uint8_t*>(partial);
  const uint32_t* tb = static_cast<const uint32_t*>(tab);
  const uint32_t log_m = ctt::log2_exact(static_cast<uint64_t>(m)), z = uint32_t(n);
  const uint32_t j = uint32_t(j0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ctt::log2_exact(static_cast<uint64_t>(k))) {
    case 0: return static_cast<int>(launch_m<0>(log_m, t, p, tb, j, z, st));
    case 1: return static_cast<int>(launch_m<1>(log_m, t, p, tb, j, z, st));
    case 2: return static_cast<int>(launch_m<2>(log_m, t, p, tb, j, z, st));
    case 3: return static_cast<int>(launch_m<3>(log_m, t, p, tb, j, z, st));
    case 4: return static_cast<int>(launch_m<4>(log_m, t, p, tb, j, z, st));
    case 5: return static_cast<int>(launch_m<5>(log_m, t, p, tb, j, z, st));
    case 6: return static_cast<int>(launch_m<6>(log_m, t, p, tb, j, z, st));
    case 7: return static_cast<int>(launch_m<7>(log_m, t, p, tb, j, z, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
