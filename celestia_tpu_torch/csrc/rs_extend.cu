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
//
// ctt_rs_extend_rows is K5's row pass alone, for K9's shards
// (celestia_tpu/parallel/sharded.py:60 `_extend_rows_local`): the same
// kernel over n row axes (gridDim.y = n, a shard's k/R rows times its
// squares), each row's Q0 half copied beside its parity.  Not a new kernel;
// its launches count as K5's.
//
// K9a `rs_col_parity_partial` (ctt_rs_col_parity_partial) replaces
// celestia_tpu/parallel/sharded.py:78-87: the `g_cols` dynamic slice of the
// bit-expanded encode matrix and the int32 matmul of a shard's bit planes,
// (G[:, 8 j0 : 8 (j0 + k/R)] @ bits) & 1, packed.  A shard holding rows
// j0 .. j0 + k/R - 1 and their row parity (`top`) computes its share of
// every parity row, partial[i, c] = XOR_{j < k/R} E[i][j0 + j] * top[j, c];
// the parity rows are the XOR of the R shards' partials (K9b,
// rs_sharded.cu).  It is this file's kernel over the 2k columns as axes with
// k/R inputs each and the shard's column slice of E as coefficients.  Bound
// on the H100: bytes at k = 128, R = 8 (16 MiB of top rows read and 128 MiB
// of partials written over the shards, ~0.045 ms; the multiply-adds, 2.1 G
// over the shards, are a few microseconds in the least-work Leopard form).
// Its launches count apart from K5's.
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
// and output lie ibs and obs bytes after square 0's.  k parity positions per
// axis from n_in inputs; E is uint8[k, n_in] (n_in = k for K5, the shard's
// k/R columns of the encode matrix for K9a).
__global__ void rs_encode_axes_kernel(AxisSet s0, AxisSet s1, const uint8_t* E,
                                      const uint8_t* gexp_g, const uint8_t* glog_g,
                                      uint32_t k, uint32_t n_in, uint32_t nsets, uint64_t ibs,
                                      uint64_t obs) {
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
  for (uint32_t idx = tid; idx < nout * n_in; idx += blockDim.x)
    logE[idx] = ctt::rs_log_entry(glog_g, E[(i0 + idx / n_in) * n_in + idx % n_in]);
  __syncthreads();
  ctt::rs_axis_body(s.in + b * ibs, s.out + b * obs, logE, nout, n_in, s.as, s.ps, s.oas,
                    s.ops, blockIdx.y, i0, tid, exp_t, log_t);
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
  rs_encode_axes_kernel<<<dim3(chunks, k, 2 * n), kThreads, 0, st>>>(rows, cols, e, ge, gl, k, k,
                                                                     2, sq_bytes, eds_bytes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const AxisSet q1cols{q1, q3, S, 2 * K * S, S, 2 * K * S};
  rs_encode_axes_kernel<<<dim3(chunks, k, n), kThreads, 0, st>>>(q1cols, q1cols, e, ge, gl, k, k,
                                                                 1, eds_bytes, eds_bytes);
  return static_cast<int>(cudaGetLastError());
}

// square uint8[k, k, 512] -> eds uint8[2k, 2k, 512]: the batch of one.
extern "C" int ctt_rs_extend(const void* square, void* eds, const void* E, const void* gexp,
                             const void* glog, int k, void* stream) {
  return ctt_rs_extend_batched(square, eds, E, gexp, glog, k, 1, stream);
}

// rows uint8[n, k, 512] -> out uint8[n, 2k, 512]: each row followed by its
// parity (Q0 | Q1 of those rows), one 2D copy and one launch.
extern "C" int ctt_rs_extend_rows(const void* rows, void* out, const void* E, const void* gexp,
                                  const void* glog, int k, int n, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint64_t S = kShareBytes, K = static_cast<uint64_t>(k);
  const uint8_t* in = static_cast<const uint8_t*>(rows);
  uint8_t* o = static_cast<uint8_t*>(out);
  const cudaError_t err =
      cudaMemcpy2DAsync(o, 2 * K * S, in, K * S, K * S, n, cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned chunks = (k + ctt::kRsOutPerBlock - 1) / ctt::kRsOutPerBlock;
  const AxisSet set{in, o + K * S, K * S, S, 2 * K * S, S};
  rs_encode_axes_kernel<<<dim3(chunks, n, 1), kThreads, 0, st>>>(
      set, set, static_cast<const uint8_t*>(E), static_cast<const uint8_t*>(gexp),
      static_cast<const uint8_t*>(glog), k, k, 1, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

// K9a: top uint8[n, n_in, 2k, 512] (each square's n_in top rows of the
// shard: Q0 | Q1) -> partial uint8[n, k, 2k, 512]; Es uint8[k, n_in] is the
// shard's column slice of gf256.encode_matrix(k, codec).  The same kernel
// with the 2k columns as axes and n_in inputs each.  One launch.
extern "C" int ctt_rs_col_parity_partial(const void* top, void* partial, const void* Es,
                                         const void* gexp, const void* glog, int k, int n_in,
                                         int n, void* stream) {
  if (n <= 0) return 0;
  const uint64_t S = kShareBytes, row = 2ull * k * S;
  const uint8_t* in = static_cast<const uint8_t*>(top);
  const unsigned chunks = (k + ctt::kRsOutPerBlock - 1) / ctt::kRsOutPerBlock;
  const AxisSet cols{in, static_cast<uint8_t*>(partial), S, row, S, row};
  rs_encode_axes_kernel<<<dim3(chunks, 2 * k, n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      cols, cols, static_cast<const uint8_t*>(Es), static_cast<const uint8_t*>(gexp),
      static_cast<const uint8_t*>(glog), k, n_in, 1, n_in * row, k * row);
  return static_cast<int>(cudaGetLastError());
}
