// Per-item body of `das_proof_gather` (das_gather.cu), shared with the g++
// CPU twin (cpu_twin.cpp).
//
// A gather *source* is one tensor of fixed-width items laid out as rows:
// item (row, idx) is the `width` bytes at base + row * row_stride +
// idx * item_stride.  An entry's sources are its NMT levels (90-byte
// digests; level 0 is the leaf grid read by rows), its RFC-6962 root-tree
// levels (32-byte hashes, one row each) and its EDS (512-byte shares).
// An item of the index table is four int32: (source, row, idx, offset of
// the item in the packed output).
#pragma once

#include <stdint.h>

#include "sha256.cuh"  // CTT_HD

namespace ctt {

constexpr uint32_t kMaxGatherSrcs = 32;

struct GatherSrc {
  const uint8_t* base;
  uint64_t row_stride;
  uint32_t item_stride;
  uint32_t width;
};

// Copy bytes lane, lane + lanes, ... of item `item` to its place in `out`.
CTT_HD void das_gather_body(const GatherSrc* srcs, const int32_t* items, uint8_t* out,
                            uint32_t item, uint32_t lane, uint32_t lanes) {
  const int32_t* it = items + 4u * item;
  const GatherSrc& s = srcs[it[0]];
  const uint8_t* src = s.base + static_cast<uint64_t>(it[1]) * s.row_stride +
                       static_cast<uint64_t>(it[2]) * s.item_stride;
  uint8_t* dst = out + static_cast<uint32_t>(it[3]);
  for (uint32_t b = lane; b < s.width; b += lanes) dst[b] = src[b];
}

}  // namespace ctt
