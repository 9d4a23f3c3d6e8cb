// Per-thread body of the Reed-Solomon extension kernel (K5, rs_extend.cu),
// shared with the g++ CPU twin (cpu_twin.cpp).
//
// Parity position i of an axis is XOR_j E[i][j] * x_j over GF(256) in the
// codec's field representation (ops/gf256.py encode_matrix), multiplied by
// log/antilog tables: a * b = exp_t[log a + log b].  The JAX
// package computes the same map lifted to GF(2) bits ((G @ bits) & 1 with
// G = bit_expand_matrix(E), ops/gf256.py:361); both give the same bytes.
#pragma once

#include <stdint.h>

#include "sha256.cuh"  // CTT_HD

namespace ctt {

constexpr uint32_t kRsOutPerBlock = 8;  // parity positions a block computes
// The log of 0.  The kernel's exp table is extended with zeros from here
// on, so exp_t[log a + log b] is 0 whenever a or b is 0 -- no branch: real
// logs are <= 254, so real sums stay below 509 and any sum with a
// kLogZero term lands in [510, 1020].
constexpr uint32_t kLogZero = 510;
constexpr uint32_t kExpEntries = 1024;

// Entry i of the extended exp table, from the codec's 512-entry table.
CTT_HD uint8_t rs_exp_entry(const uint8_t* gexp, uint32_t i) {
  return i < kLogZero ? gexp[i] : 0;
}

// Entry v of the log table with log(0) = kLogZero.
CTT_HD uint16_t rs_log_entry(const uint8_t* glog, uint32_t v) {
  return v ? glog[v] : static_cast<uint16_t>(kLogZero);
}

// One thread: bytes [4t, 4t+4) of parity positions i0 .. i0+nout-1 of axis
// a, from its n_in input positions (k for K5; k/R for K9a's partial,
// rs_extend.cu).  Input axis a, position j lies at in + a*as + j*ps;
// output position i at out + a*oas + i*ops.  logE holds the log of input
// j's coefficient for output i0 + o at o*n_in + j; exp and log are the
// extended tables above.  The logs of an input word's four bytes are
// looked up once and serve all nout outputs.
CTT_HD void rs_axis_body(const uint8_t* in, uint8_t* out, const uint16_t* logE, uint32_t nout,
                         uint32_t n_in, uint64_t as, uint64_t ps, uint64_t oas, uint64_t ops,
                         uint32_t a, uint32_t i0, uint32_t t, const uint8_t* exp_t,
                         const uint16_t* log_t) {
  uint32_t acc[kRsOutPerBlock];
#pragma unroll
  for (uint32_t o = 0; o < kRsOutPerBlock; ++o) acc[o] = 0u;
  const uint8_t* src = in + a * as + 4u * t;
  for (uint32_t j = 0; j < n_in; ++j) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(src + j * ps);
    const uint32_t l0 = log_t[x & 0xFFu], l1 = log_t[(x >> 8) & 0xFFu];
    const uint32_t l2 = log_t[(x >> 16) & 0xFFu], l3 = log_t[x >> 24];
#pragma unroll
    for (uint32_t o = 0; o < kRsOutPerBlock; ++o) {
      if (o < nout) {
        const uint32_t lc = logE[o * n_in + j];
        acc[o] ^= uint32_t(exp_t[l0 + lc]) | (uint32_t(exp_t[l1 + lc]) << 8) |
                  (uint32_t(exp_t[l2 + lc]) << 16) | (uint32_t(exp_t[l3 + lc]) << 24);
      }
    }
  }
  uint8_t* dst = out + a * oas + 4u * t;
#pragma unroll
  for (uint32_t o = 0; o < kRsOutPerBlock; ++o)
    if (o < nout) *reinterpret_cast<uint32_t*>(dst + (i0 + o) * ops) = acc[o];
}

}  // namespace ctt
