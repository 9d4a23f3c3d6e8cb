// The second kernel of the sharded block extension K9
// (celestia_tpu/parallel/sharded.py:65 `_sharded_extend_and_roots`, the
// shard_map body built by `_build_sharded_fn` :168).  The rest of K9 is a
// launch sequence in parallel/sharded.py: K5's row pass and K9a
// `rs_col_parity_partial` (rs_extend.cu ctt_rs_extend_rows,
// ctt_rs_col_parity_partial), K2 over a row window, K3, K4, and the copies
// of parallel/collectives.py.
//
// K9b `xor_reduce_slabs` replaces the reduction half of
// `psum_scatter(...) & 1` (sharded.py:89-90; an int32 sum of 0/1 bit planes
// then & 1 is an XOR).  Bound by bytes: per destination shard, R slabs
// read and one written (at k = 128, R = 8: 128 MiB read, 16 MiB written).
// Design: one launch per device serves every destination shard on it
// (grid y), reading slab d of each peer's partial where it lies -- in place
// when the peer's partial is on this device, so a mesh that repeats one
// card stages nothing -- with the partials' base pointers, each
// destination's slab offset and the batch stride by value.  One thread per 16 bytes of output does R 16-byte loads, R a
// template parameter (1, 2, 4, 8) so the loop unrolls and every load is
// in flight before the first XOR; grid z walks the batch (the `groups` /
// `nb` leading dimension, which makes a slab non-contiguous).
#include <cuda_runtime.h>

#include "rs_sharded.cuh"

namespace {

constexpr unsigned kThreads = 256;

template <uint32_t R>
__global__ void xor_reduce_kernel(ctt::XorSlabs a, uint64_t slab_words) {
  const uint64_t w = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (w >= slab_words) return;
  ctt::xor_reduce_word<R>(a, blockIdx.y, blockIdx.z, slab_words, w);
}

template <uint32_t R>
void launch(const ctt::XorSlabs& a, uint32_t n_dst, uint32_t nb, uint64_t slab_words,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((slab_words + kThreads - 1) / kThreads), n_dst, nb);
  xor_reduce_kernel<R><<<grid, kThreads, 0, stream>>>(a, slab_words);
}

}  // namespace

// peers: host int64[R], the R partials' base pointers; dsts, offs: host
// int64[n_dst], each destination (uint8[nb, slab_bytes] contiguous) and the
// byte offset of its slab in every partial; bstride: bytes between batches
// in a partial.  Every pointer, offset and stride a multiple of 16, as
// slab_bytes; R in {1, 2, 4, 8}, n_dst <= 8, nb <= 65535.  One launch.
extern "C" int ctt_xor_reduce_scatter(const long long* peers, int R, const long long* dsts,
                                      const long long* offs, int n_dst, long long slab_bytes,
                                      int nb, long long bstride, void* stream) {
  if (R < 1 || R > static_cast<int>(ctt::kXorMaxShards) || (R & (R - 1)) || n_dst < 1 ||
      n_dst > static_cast<int>(ctt::kXorMaxShards) || nb < 1 || nb > 65535 || slab_bytes < 0 ||
      bstride < 0 || ((slab_bytes | bstride) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  ctt::XorSlabs a = {};
  uint64_t bad = 0;
  for (int j = 0; j < R; ++j) {
    a.peer[j] = reinterpret_cast<const uint8_t*>(static_cast<uintptr_t>(peers[j]));
    bad |= static_cast<uint64_t>(peers[j]);
  }
  for (int i = 0; i < n_dst; ++i) {
    a.dst[i] = reinterpret_cast<uint8_t*>(static_cast<uintptr_t>(dsts[i]));
    a.off[i] = static_cast<uint64_t>(offs[i]);
    bad |= static_cast<uint64_t>(dsts[i]) | a.off[i];
  }
  if (bad & 15u) return static_cast<int>(cudaErrorInvalidValue);
  a.bstride = static_cast<uint64_t>(bstride);
  const uint64_t slab_words = static_cast<uint64_t>(slab_bytes) / 16u;
  if (slab_words == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: launch<1>(a, n_dst, nb, slab_words, s); break;
    case 2: launch<2>(a, n_dst, nb, slab_words, s); break;
    case 4: launch<4>(a, n_dst, nb, slab_words, s); break;
    default: launch<8>(a, n_dst, nb, slab_words, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
