// Per-thread bodies of the repair kernels (rs_decode.cu): K8a the Lagrange
// decode matrices, K8b the decode of an orientation's solvable axes in
// place, K8c the two per-cell verdicts of a repair.  Shared with the g++
// CPU twin (cpu_twin.cpp).
//
// The JAX package decodes by lifting D to GF(2) bits and multiplying on
// the MXU (ops/rs.py:191-224); these bodies multiply in GF(256) with the
// codec's log/antilog tables, as K5 does (rs_extend.cuh).  Both give the
// same bytes.
#pragma once

#include <stdint.h>
#include <string.h>

#include "rs_extend.cuh"

namespace ctt {

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

// K8b: the positions of a 2k-position axis that are not among its k known
// ones, ascending, into opos[0..k).  Serial (one thread of a block): 2k
// flag steps.
CTT_HD void rs_unknown_positions(const uint8_t* kpos, uint32_t k, uint8_t* opos) {
  uint8_t known[256];
  for (uint32_t i = 0; i < 2 * k; ++i) known[i] = 0;
  for (uint32_t j = 0; j < k; ++j) known[kpos[j]] = 1;
  uint32_t n = 0;
  for (uint32_t i = 0; i < 2 * k && n < k; ++i)
    if (!known[i]) opos[n++] = static_cast<uint8_t>(i);
}

// K8b: whether axis `axis` and its known positions lie inside the 2k x 2k
// square, so that a malformed table can neither read nor write past it.
CTT_HD bool rs_axis_in_bounds(const uint8_t* kpos, uint32_t k, int32_t axis) {
  bool ok = axis >= 0 && static_cast<uint32_t>(axis) < 2 * k;
  for (uint32_t j = 0; j < k; ++j) ok = ok && kpos[j] < 2 * k;
  return ok;
}

// K8b, one thread: bytes [4t, 4t+4) of outputs opos[0..nout) of axis
// `axis`, position p of which lies at eds + axis*as + p*ps.  Reads only the
// known positions kpos[0..k) and writes only unknown ones, so the blocks of
// one axis never race.  logD holds log D[opos[o]][j] at o*k + j.  The known
// positions are not written: D's rows there are one-hot, so the JAX
// program writes back the bytes already present (:249, :252).
CTT_HD void rs_decode_body(uint8_t* eds, const uint16_t* logD, const uint8_t* kpos,
                           const uint8_t* opos, uint32_t nout, uint32_t k, uint64_t as,
                           uint64_t ps, uint32_t axis, uint32_t t, const uint8_t* exp_t,
                           const uint16_t* log_t) {
  uint32_t acc[kRsOutPerBlock];
#pragma unroll
  for (uint32_t o = 0; o < kRsOutPerBlock; ++o) acc[o] = 0u;
  uint8_t* base = eds + axis * as + 4u * t;
  for (uint32_t j = 0; j < k; ++j) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(base + kpos[j] * ps);
    const uint32_t l0 = log_t[x & 0xFFu], l1 = log_t[(x >> 8) & 0xFFu];
    const uint32_t l2 = log_t[(x >> 16) & 0xFFu], l3 = log_t[x >> 24];
#pragma unroll
    for (uint32_t o = 0; o < kRsOutPerBlock; ++o) {
      if (o < nout) {
        const uint32_t lc = logD[o * k + j];
        acc[o] ^= uint32_t(exp_t[l0 + lc]) | (uint32_t(exp_t[l1 + lc]) << 8) |
                  (uint32_t(exp_t[l2 + lc]) << 16) | (uint32_t(exp_t[l3 + lc]) << 24);
      }
    }
  }
#pragma unroll
  for (uint32_t o = 0; o < kRsOutPerBlock; ++o)
    if (o < nout) *reinterpret_cast<uint32_t*>(base + opos[o] * ps) = acc[o];
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
