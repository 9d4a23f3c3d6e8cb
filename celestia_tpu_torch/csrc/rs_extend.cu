// K5 `rs_extend`: the 2D Reed-Solomon extension of a k x k square of
// 512-byte shares into its 2k x 2k extended data square.
//
// Replaces: celestia_tpu/ops/rs.py:64 `_extend` (with `unpack_bits` :36,
// `pack_bits` :44, `matmul_gf2` :52, `_row_parity` :58; jit `_extend_fn`
// :76, entry `extend_square` :82).  Q1 = row parity of Q0, Q2 = column
// parity of Q0, Q3 = column parity of Q1, exactly as `_extend` orders them.
//
// Bound on the H100: operations.  The JAX formulation's GF(2) bit-GEMM is
// 2 * 8k * 8k * 3k * 512 int8 operations (412 G at k = 128, ~0.21 ms at
// 1,979 TOPS) against ~40 MiB of HBM traffic (~13 us).
// Design (the simple form; the int8 tensor-core bit-GEMM is later work):
// GF(256) multiply by log/antilog tables held in shared memory (1.5 KB --
// the 64 KiB full product table would not fit the 48 KB of static shared
// memory; the exp table is zero-extended so a zero operand needs no
// branch), one thread per 4-byte column slice of a share, 8 parity
// positions per block so each loaded input word, and the logs of its four
// bytes, feed 8 accumulators.
// Launch 1 computes Q1 and Q2 (blockIdx.z picks the stride set), launch 2
// Q3 from Q1; Q0 is one 2D device copy.  All on the caller's stream.
//
// K5b `rs_extend_batched` (ctt_rs_extend_batched) replaces
// celestia_tpu/ops/rs.py:102 `_extend_batched_fn` (jax.vmap of `_extend`)
// under :107 `extend_squares_batched`: the same two launches over a batch
// of n squares, blockIdx.z = square * (stride sets) + set, and one 2D copy
// of Q0 per square.
#include <cuda_runtime.h>

#include "rs_extend.cuh"

namespace {

constexpr uint32_t kMaxK = 128;
constexpr uint32_t kShareBytes = 512;
constexpr uint32_t kThreads = kShareBytes / 4;  // one 4-byte slice each

// One family of axes: axis a, position j at in + a*as + j*ps; parity
// position i written to out + a*oas + i*ops.
struct AxisSet {
  const uint8_t* in;
  uint8_t* out;
  uint64_t as, ps, oas, ops;
};

// blockIdx.z = b * nsets + set: stride set `set` of square b, whose input
// and output lie ibs and obs bytes after square 0's.
__global__ void rs_encode_axes_kernel(AxisSet s0, AxisSet s1, const uint8_t* E,
                                      const uint8_t* gexp_g, const uint8_t* glog_g,
                                      uint32_t k, uint32_t nsets, uint64_t ibs, uint64_t obs) {
  __shared__ uint8_t exp_t[ctt::kExpEntries];
  __shared__ uint16_t log_t[256];
  __shared__ uint16_t logE[ctt::kRsOutPerBlock * kMaxK];
  const AxisSet s = blockIdx.z % nsets ? s1 : s0;
  const uint64_t b = blockIdx.z / nsets;
  const uint32_t tid = threadIdx.x;
  for (uint32_t i = tid; i < ctt::kExpEntries; i += blockDim.x)
    exp_t[i] = ctt::rs_exp_entry(gexp_g, i);
  for (uint32_t v = tid; v < 256u; v += blockDim.x) log_t[v] = ctt::rs_log_entry(glog_g, v);
  const uint32_t i0 = blockIdx.x * ctt::kRsOutPerBlock;
  const uint32_t nout = k - i0 < ctt::kRsOutPerBlock ? k - i0 : ctt::kRsOutPerBlock;
  for (uint32_t idx = tid; idx < nout * k; idx += blockDim.x)
    logE[idx] = ctt::rs_log_entry(glog_g, E[(i0 + idx / k) * k + idx % k]);
  __syncthreads();
  ctt::rs_axis_body(s.in + b * ibs, s.out + b * obs, logE, nout, k, s.as, s.ps, s.oas, s.ops,
                    blockIdx.y, i0, tid, exp_t, log_t);
}

}  // namespace

// squares uint8[n, k, k, 512] -> eds uint8[n, 2k, 2k, 512] in two launches
// for the batch; E uint8[k, k] is gf256.encode_matrix(k, codec), gexp
// uint8[512] / glog uint8[256] the codec's field tables.
extern "C" int ctt_rs_extend_batched(const void* squares, void* eds, const void* E,
                                     const void* gexp, const void* glog, int k, int n,
                                     void* stream) {
  if (n <= 0) return 0;
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
  const uint8_t* e = static_cast<const uint8_t*>(E);
  const uint8_t* ge = static_cast<const uint8_t*>(gexp);
  const uint8_t* gl = static_cast<const uint8_t*>(glog);
  const unsigned chunks = (k + ctt::kRsOutPerBlock - 1) / ctt::kRsOutPerBlock;
  const AxisSet rows{q0, q1, K * S, S, 2 * K * S, S};
  const AxisSet cols{q0, q2, S, K * S, S, 2 * K * S};
  rs_encode_axes_kernel<<<dim3(chunks, k, 2 * n), kThreads, 0, st>>>(rows, cols, e, ge, gl, k, 2,
                                                                     sq_bytes, eds_bytes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const AxisSet q1cols{q1, q3, S, 2 * K * S, S, 2 * K * S};
  rs_encode_axes_kernel<<<dim3(chunks, k, n), kThreads, 0, st>>>(q1cols, q1cols, e, ge, gl, k, 1,
                                                                 eds_bytes, eds_bytes);
  return static_cast<int>(cudaGetLastError());
}

// square uint8[k, k, 512] -> eds uint8[2k, 2k, 512]: the batch of one.
extern "C" int ctt_rs_extend(const void* square, void* eds, const void* E, const void* gexp,
                             const void* glog, int k, void* stream) {
  return ctt_rs_extend_batched(square, eds, E, gexp, glog, k, 1, stream);
}
