// Per-thread bodies of the repair kernels (rs_decode.cu): K8a the Lagrange
// decode matrices, K8b's prologue (which positions of an axis it decodes;
// its GEMM is K5's, rs_extend.cuh), K8c the two per-cell verdicts of a
// repair.  Shared with the g++ CPU twin (cpu_twin.cpp).
#pragma once

#include <stdint.h>
#include <string.h>

#include "rs_extend.cuh"

namespace ctt {

CTT_HD uint32_t popcount32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return static_cast<uint32_t>(__builtin_popcount(x));
#endif
}

constexpr uint32_t kGfOrder = 255;
constexpr uint32_t kVerdictLanes = 32;  // one warp per 512-byte cell, 16 bytes a lane

// K8a, per source point j: sum over m of log[src_j ^ src_m] mod 255, the
// diagonal counted as log[1] -- ops/rs.py:162-164 exactly, including the
// raw table entry at 0 should two points coincide.
CTT_HD uint32_t rs_denom_log(const uint8_t* src, uint32_t k, uint32_t j, const uint8_t* glog) {
  uint32_t s = 0;
  for (uint32_t m = 0; m < k; ++m) s += glog[m == j ? 1u : uint32_t(src[j] ^ src[m])];
  return s % kGfOrder;
}

// K8a, one output row: D[i][0..k) for the field point dst of position i.
// A destination that is a source point gives a one-hot row (:173-175);
// otherwise D[i][j] = exp[(num_log - denom_log[j]) mod 255] with the floor
// modulo of :172 (255 is added before the remainder: C++ % truncates).
// Zero differences are looked up as 1, as :167 does.
CTT_HD void rs_decode_row(const uint8_t* src, const uint16_t* denom_log, uint32_t k, uint32_t dst,
                          const uint8_t* gexp, const uint8_t* glog, uint8_t* out) {
  uint32_t total = 0;
  bool has_zero = false;
  for (uint32_t m = 0; m < k; ++m) {
    const uint32_t d = dst ^ src[m];
    has_zero = has_zero || d == 0;
    total += glog[d ? d : 1u];
  }
  for (uint32_t j = 0; j < k; ++j) {
    const uint32_t d = dst ^ src[j];
    if (has_zero) {
      out[j] = d == 0 ? 1 : 0;
    } else {
      const uint32_t num = (total - glog[d]) % kGfOrder;
      out[j] = gexp[(num + kGfOrder - denom_log[j]) % kGfOrder];
    }
  }
}

// K8b, the block prologue: known_bits (8 words, bit p of word p / 32) marks
// the axis's known positions.  Position p < 2k, if not known, is output
// rs_unknown_rank(known_bits, p) of the axis: its rank among the unknown
// positions, ascending.  The decode writes the first k of them.
CTT_HD uint32_t rs_unknown_rank(const uint32_t* known_bits, uint32_t p) {
  uint32_t below = 0;
  for (uint32_t w = 0; w < p / 32; ++w) below += popcount32(known_bits[w]);
  below += popcount32(known_bits[p / 32] & ((1u << (p % 32)) - 1u));
  return p - below;
}

CTT_HD bool rs_is_known(const uint32_t* known_bits, uint32_t p) {
  return (known_bits[p / 32] >> (p % 32)) & 1u;
}

struct Bytes16 {
  uint64_t lo, hi;
};

CTT_HD Bytes16 load16(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(p);  // one 16-byte load
  return Bytes16{v.x, v.y};
#else
  Bytes16 v;
  memcpy(&v, p, 16);
  return v;
#endif
}

// K8c, lane `lane` of cell `cell` (bytes [16 lane, 16 lane + 16) of the
// cell's 512): bit 0 set when repaired != recomputed there, bit 1 when
// repaired != provided (ops/rs.py:276-277).  The kernel ORs the bits over
// the warp.
CTT_HD uint32_t rs_verdict_lane(const uint8_t* repaired, const uint8_t* recomputed,
                                const uint8_t* provided, uint64_t cell, uint32_t lane) {
  const uint64_t off = cell * 512u + 16u * lane;
  const Bytes16 a = load16(repaired + off), b = load16(recomputed + off), c = load16(provided + off);
  const uint32_t d0 = ((a.lo ^ b.lo) | (a.hi ^ b.hi)) != 0 ? 1u : 0u;
  const uint32_t d1 = ((a.lo ^ c.lo) | (a.hi ^ c.hi)) != 0 ? 2u : 0u;
  return d0 | d1;
}

}  // namespace ctt
