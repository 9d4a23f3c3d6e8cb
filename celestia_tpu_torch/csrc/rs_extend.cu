// K5 `rs_extend`: the 2D Reed-Solomon extension of a k x k square of
// 512-byte shares into its 2k x 2k extended data square.
//
// Replaces: celestia_tpu/ops/rs.py:64 `_extend` (with `unpack_bits` :36,
// `pack_bits` :44, `matmul_gf2` :52, `_row_parity` :58; jit `_extend_fn`
// :76, entry `extend_square` :82).  Q1 = row parity of Q0, Q2 = column
// parity of Q0, Q3 = column parity of Q1, exactly as `_extend` orders them.
//
// Bound on the H100 at k = 128, for three forms of the work:
// - bytes: ~40 MiB of HBM traffic a square (Q0 read, the EDS written),
//   ~0.0125 ms at 3.35 TB/s -- the bound chip_smoke.py reports, since the
//   least-work form (Leopard's O(k log k) IFFT/FFT, leopard-ff8 only) fits
//   under it;
// - the JAX package's bit-GEMM, the form computed here: 2 * 8k * 8k * 3k *
//   512 = 412 G int8 operations, 0.208 ms at the 1,979 TOPS int8
//   tensor-core peak (the "tensor-core floor").
// Design: the bit-GEMM on the tensor cores (rs_extend.cuh): int8 mma.sync
// m16n8k32 with both operands built in registers -- G's rows from a
// product table made in the block prologue from the codec's exp/log
// tables, never stored in HBM; the data bits from the input bytes, loaded
// straight into registers a chunk ahead and never written anywhere -- and
// the parity bits packed into bytes in the epilogue, 16 bytes a lane.  A
// block computes 8 outputs of each of up to 8 axes (the coefficient
// prologue shared by its axes), 8 warps x 64 bytes of each axis.
// Launch 1 computes Q1 and Q2 (blockIdx.z picks the stride set), launch 2
// Q3 from Q1; Q0 is one 2D device copy.  All on the caller's stream.
//
// K5b `rs_extend_batched` (ctt_rs_extend_batched) replaces
// celestia_tpu/ops/rs.py:102 `_extend_batched_fn` (jax.vmap of `_extend`)
// under :107 `extend_squares_batched`: the same two launches over a batch
// of n squares, blockIdx.z = square * (stride sets) + set, and one 2D copy
// of Q0 per square.  Its floor is n times K5's.
//
// ctt_rs_extend_rows is K5's row pass alone, for K9's shards
// (celestia_tpu/parallel/sharded.py:60 `_extend_rows_local`): the same
// kernel over n row axes, each row's Q0 half copied beside its parity.
// Not a new kernel; its launches count as K5's.
//
// K9a `rs_col_parity_partial` (ctt_rs_col_parity_partial) replaces
// celestia_tpu/parallel/sharded.py:78-87: the `g_cols` dynamic slice of the
// bit-expanded encode matrix and the int32 matmul of a shard's bit planes,
// (G[:, 8 j0 : 8 (j0 + k/R)] @ bits) & 1, packed.  A shard holding rows
// j0 .. j0 + k/R - 1 and their row parity (`top`) computes its share of
// every parity row, partial[i, c] = XOR_{j < k/R} E[i][j0 + j] * top[j, c];
// the parity rows are the XOR of the R shards' partials (K9b,
// rs_sharded.cu).  It is this file's kernel over the 2k columns as axes with
// k/R inputs each (K = 8k/R deep, zero-padded to whole k-steps below 4
// inputs) and the shard's column slice of E as coefficients.  Bound on the
// H100 at k = 128, R = 8: bytes (16 MiB of top rows read and 128 MiB of
// partials written over the shards, ~0.045 ms); its tensor-core floor over
// the 8 shards is 275 G int8 operations, 0.139 ms.  Its launches count
// apart from K5's.
#include <cuda_runtime.h>

#include "rs_extend.cuh"
#include "launch.cuh"

namespace {

constexpr uint32_t kShareBytes = 512;

// One family of axes: axis a, position j at in + a*as + j*ps; parity
// position i written to out + a*oas + i*ops.
struct AxisSet {
  const uint8_t* in;
  uint8_t* out;
  uint64_t as, ps, oas, ops;
};

// blockIdx.z = b * nsets + set: stride set `set` of square b, whose input
// and output lie ibs and obs bytes after square 0's; blockIdx.y the group
// of `apb` axes of n_axes, blockIdx.x the group of 8 outputs of k.  E is
// uint8[k, n_in] (n_in = k for K5, the shard's k/R columns of the encode
// matrix for K9a).
__global__ void __launch_bounds__(ctt::kGf2Threads, 1)
    rs_gf2_encode_kernel(AxisSet s0, AxisSet s1, const uint8_t* E, const uint8_t* gexp,
                         const uint8_t* glog, uint32_t k, uint32_t n_in, uint32_t n_axes,
                         uint32_t apb, uint32_t nsets, uint64_t ibs, uint64_t obs) {
  extern __shared__ __align__(16) uint8_t smem[];
  const ctt::Gf2Smem sh(smem, n_in);
  const AxisSet s = blockIdx.z % nsets ? s1 : s0;
  const uint64_t b = blockIdx.z / nsets;
  const uint32_t i0 = blockIdx.x * ctt::kGf2Outputs;
  const uint32_t nout = k - i0 < ctt::kGf2Outputs ? k - i0 : ctt::kGf2Outputs;
  const uint32_t a0 = blockIdx.y * apb;
  const uint32_t na = n_axes - a0 < apb ? n_axes - a0 : apb;
  const ctt::Gf2EncodeAxes ax{s.in + b * ibs + a0 * s.as,
                              s.out + b * obs + a0 * s.oas + i0 * s.ops,
                              s.as, s.ps, s.oas, s.ops, nout};
  uint32_t first[4][2], coef[ctt::kGf2ItemsPerThread];
  ctt::gf2_lane_chunk(ax, 0, n_in, 0, threadIdx.x / 32, threadIdx.x % 32, first);
  ctt::gf2_fetch_coef(1, nout, n_in, [&](uint32_t o, uint32_t j) { return E[(i0 + o) * n_in + j]; },
                      coef);
  ctt::gf2_load_tables(sh, gexp, glog);
  __syncthreads();
  ctt::gf2_build_products(sh);
  __syncthreads();
  ctt::gf2_expand(sh, 1, n_in, coef);
  __syncthreads();
  ctt::gf2_gemm(ax, na, n_in, sh, first);
}

// One launch: k outputs of n_axes axes of each of nz (square, set) pairs.
// The first launch on a device raises the kernel's dynamic shared memory
// limit to the most it can ask (k = 128) above the default 48 KB.
int launch_encode(const AxisSet& s0, const AxisSet& s1, const void* E, const void* gexp,
                  const void* glog, uint32_t k, uint32_t n_in, uint32_t n_axes, uint32_t nsets,
                  uint32_t nz, uint64_t ibs, uint64_t obs, cudaStream_t st) {
  const cudaError_t err =
      ctt::raise_smem_once<rs_gf2_encode_kernel>(ctt::gf2_smem_bytes(ctt::kGf2MaxInputs, 1));
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint32_t groups = (k + ctt::kGf2Outputs - 1) / ctt::kGf2Outputs;
  const uint32_t apb = ctt::gf2_axes_per_block(groups * nz, n_axes);
  rs_gf2_encode_kernel<<<dim3(groups, (n_axes + apb - 1) / apb, nz), ctt::kGf2Threads,
                         ctt::gf2_smem_bytes(n_in, 1), st>>>(
      s0, s1, static_cast<const uint8_t*>(E), static_cast<const uint8_t*>(gexp),
      static_cast<const uint8_t*>(glog), k, n_in, n_axes, apb, nsets, ibs, obs);
  return static_cast<int>(cudaGetLastError());
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
  const AxisSet rows{q0, q1, K * S, S, 2 * K * S, S};
  const AxisSet cols{q0, q2, S, K * S, S, 2 * K * S};
  const int err = launch_encode(rows, cols, E, gexp, glog, k, k, k, 2, 2 * n, sq_bytes, eds_bytes,
                                st);
  if (err != 0) return err;
  const AxisSet q1cols{q1, q3, S, 2 * K * S, S, 2 * K * S};
  return launch_encode(q1cols, q1cols, E, gexp, glog, k, k, k, 1, n, eds_bytes, eds_bytes, st);
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
  const AxisSet set{in, o + K * S, K * S, S, 2 * K * S, S};
  return launch_encode(set, set, E, gexp, glog, k, k, n, 1, 1, 0, 0, st);
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
  const AxisSet cols{static_cast<const uint8_t*>(top), static_cast<uint8_t*>(partial), S, row, S,
                     row};
  return launch_encode(cols, cols, Es, gexp, glog, k, n_in, 2 * k, 1, n, n_in * row, k * row,
                       static_cast<cudaStream_t>(stream));
}
