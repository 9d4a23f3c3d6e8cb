// Per-thread body of the sharded extension's XOR reduce-scatter (K9b in
// rs_sharded.cu), shared with the g++ CPU twin (cpu_twin.cpp).
//
// A K9 shard holding k/R rows computes its share of every parity row (K9a,
// rs_extend.cu); the parity rows are the XOR of the R shards' partials, and
// destination shard d gets slab d of that XOR.  K9b reads slab d of each of
// the R partials where it lies -- in place on the destination's device, or
// the copy staged there from another card -- and XORs them.
#pragma once

#include <stdint.h>

#include "sha256.cuh"  // CTT_HD, Word16

namespace ctt {

constexpr uint32_t kXorMaxShards = 8;  // R, and the destinations of one launch

// One launch's slabs: destination i (of those on the launch's device) is
// dst[i], uint8[nb, slab] contiguous; its R inputs are the slabs at byte
// off[i] + b * bstride of peer[j] for batch b (slab d of peer j's partial,
// read where it lies, at off = d * slab stride).
struct XorSlabs {
  const uint8_t* peer[kXorMaxShards];
  uint8_t* dst[kXorMaxShards];
  uint64_t off[kXorMaxShards];
  uint64_t bstride;
};

// K9b, one thread: 16-byte word w of batch b of destination i, the XOR of
// that word of its R slabs (every load issued before the first XOR).
template <uint32_t R>
CTT_HD void xor_reduce_word(const XorSlabs& a, uint32_t i, uint64_t b, uint64_t slab_words,
                            uint64_t w) {
  const uint64_t at = a.off[i] + b * a.bstride;
  Word16 v[R];
#pragma unroll
  for (uint32_t j = 0; j < R; ++j) v[j] = reinterpret_cast<const Word16*>(a.peer[j] + at)[w];
  Word16 acc = v[0];
#pragma unroll
  for (uint32_t j = 1; j < R; ++j) {
    acc.x ^= v[j].x;
    acc.y ^= v[j].y;
    acc.z ^= v[j].z;
    acc.w ^= v[j].w;
  }
  reinterpret_cast<Word16*>(a.dst[i])[b * slab_words + w] = acc;
}

}  // namespace ctt
