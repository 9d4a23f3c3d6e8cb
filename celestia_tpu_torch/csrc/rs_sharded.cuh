// Per-thread body of the sharded extension's XOR reduction (K9b in
// rs_sharded.cu), shared with the g++ CPU twin (cpu_twin.cpp).
//
// A K9 shard holding k/R rows computes its share of every parity row (K9a,
// rs_extend.cu); the parity rows are the XOR of the R shards' partials, and
// after the reduce-scatter has brought slab d of every partial to shard d,
// K9b XORs those R slabs.
#pragma once

#include <stdint.h>

#include "sha256.cuh"  // CTT_HD

namespace ctt {

// 16 bytes, as one vector load or store on the card.
#ifdef __CUDACC__
using Word16 = uint4;
#else
struct alignas(16) Word16 {
  uint32_t x, y, z, w;
};
#endif

// K9b, one thread: word w of the output, the XOR of word w of the R slabs
// laid one after another, n_words words each.
CTT_HD void xor_reduce_body(const uint8_t* staged, uint8_t* out, uint32_t R, uint64_t n_words,
                            uint64_t w) {
  const Word16* src = reinterpret_cast<const Word16*>(staged) + w;
  Word16 acc = src[0];
  for (uint32_t s = 1; s < R; ++s) {
    const Word16 v = src[s * n_words];
    acc.x ^= v.x;
    acc.y ^= v.y;
    acc.z ^= v.z;
    acc.w ^= v.w;
  }
  reinterpret_cast<Word16*>(out)[w] = acc;
}

}  // namespace ctt
