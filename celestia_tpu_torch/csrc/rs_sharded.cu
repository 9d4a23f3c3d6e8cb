// The second kernel of the sharded block extension K9
// (celestia_tpu/parallel/sharded.py:65 `_sharded_extend_and_roots`, the
// shard_map body built by `_build_sharded_fn` :168).  The rest of K9 is a
// launch sequence in parallel/sharded.py: K5's row pass and K9a
// `rs_col_parity_partial` (rs_extend.cu ctt_rs_extend_rows,
// ctt_rs_col_parity_partial), K2 over a row window, K3, K1 + K4, and the
// copies of parallel/collectives.py.
//
// K9b `xor_reduce_slabs` replaces the reduction half of
// `psum_scatter(...) & 1` (sharded.py:89-90; an int32 sum of 0/1 bit planes
// then & 1 is an XOR).  The packed reduce-scatter (parallel/collectives.py)
// stages slab d of every shard's partial on shard d, R slabs one after
// another; K9b XORs them into the shard's parity rows.  Bound by bytes: R
// slabs read, one written.  Design: one thread per 16 bytes of output, R
// 16-byte loads and XORs.
#include <cuda_runtime.h>

#include "rs_sharded.cuh"

namespace {

__global__ void xor_reduce_kernel(const uint8_t* staged, uint8_t* out, uint32_t R,
                                  uint64_t n_words) {
  const uint64_t w = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= n_words) return;
  ctt::xor_reduce_body(staged, out, R, n_words, w);
}

}  // namespace

// staged: R slabs of nbytes each, one after another, 16-byte aligned ->
// out uint8[nbytes], their XOR; nbytes a multiple of 16.  One launch.
extern "C" int ctt_xor_reduce_slabs(const void* staged, void* out, int R, long long nbytes,
                                    void* stream) {
  const uint64_t n_words = static_cast<uint64_t>(nbytes) / 16u;
  if (n_words == 0) return 0;
  const int threads = 256;
  xor_reduce_kernel<<<static_cast<unsigned>((n_words + threads - 1) / threads), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(staged), static_cast<uint8_t*>(out),
      static_cast<uint32_t>(R), n_words);
  return static_cast<int>(cudaGetLastError());
}
