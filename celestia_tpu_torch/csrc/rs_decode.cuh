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

constexpr uint32_t kVerdictLanes = 32;  // one warp per 512-byte cell, 16 bytes a lane

// --- K8a: the Lagrange decode matrices (ops/rs.py:150 exactly) -------------
//
// D[i][j] for output position i and source point s_j of an axis, with dst =
// i ^ xor_const: exp[(num_i - denom_j) mod 255], num_i = total_i - log[dst ^
// s_j] and total_i the sum over m of log[dst ^ s_m] (a zero difference
// looked up as 1); denom_j the sum over m of log[s_j ^ s_m] with the
// diagonal counted as log[1] (the raw log[0] entry should two points
// coincide); a row whose dst is a source point is one-hot (1 where dst ==
// s_j).  The modulos are floor modulos.
//
// A block builds the matrices of `na` consecutive axes (na * k <= 128) in
// three steps with a barrier between them: stage the tables and the source
// points; the sums (every denominator and every row's total, reduced mod 255
// once), a group of 4 lanes an item, lanes splitting m, a shuffle reduce;
// then D, a thread per run of min(16, k) bytes of one row, so that a warp
// stores 512 contiguous bytes with 16-byte stores.  An entry is table
// lookups and adds: with total and denom reduced once, total - log - denom +
// 510 lies in [2, 764], so exp is tripled in shared memory (exp3[x] =
// exp[x mod 255]) and no entry takes a modulo.
constexpr uint32_t kGfOrder = 255;
constexpr uint32_t kDmMaxK = 128;
constexpr uint32_t kDmThreads = 256;
constexpr uint32_t kDmGroup = 4;       // lanes that share a sum item
constexpr uint32_t kDmExp3 = 768;      // 3 * 255 entries, padded
constexpr uint32_t kDmFillBlocks = 264;  // blocks that fill the card (two a SM) before axes share one

struct DmSmem {
  uint8_t src[kDmMaxK];        // the block's axes' source points, axis after axis
  uint8_t denom[kDmMaxK];      // their denominators, mod 255
  uint8_t row_log[2 * kDmMaxK];   // each output row's total, mod 255
  uint8_t row_zero[2 * kDmMaxK];  // 1 where the row's point is a source point
  uint8_t exp3[kDmExp3];
  uint8_t log[256];
};

// Axes a block takes: one, or several at small k when there are more axes
// than the card's two blocks a SM.
CTT_HD uint32_t rs_dm_axes_per_block(uint32_t n, uint32_t k) {
  const uint32_t most = kDmMaxK / k, want = (n + kDmFillBlocks - 1) / kDmFillBlocks;
  return want < 1 ? 1 : (want > most ? most : want);
}

// x mod 255 for x < 65536, by folding (256 = 1 mod 255): no division.
CTT_HD uint32_t mod255(uint32_t x) {
  x = (x & 0xFFu) + (x >> 8);
  x = (x & 0xFFu) + (x >> 8);
  return x >= kGfOrder ? x - kGfOrder : x;
}

// Step 1, thread tid of nthreads: the tables and the source points of axes
// a0 .. a0 + na - 1 (known uint8[n, k], consecutive axes consecutive).
CTT_HD void rs_dm_stage(DmSmem& sh, const uint8_t* known, uint64_t a0, uint32_t na, uint32_t k,
                        uint32_t xor_const, const uint8_t* gexp, const uint8_t* glog, uint32_t tid,
                        uint32_t nthreads) {
  for (uint32_t x = tid; x < kDmExp3; x += nthreads) {
    const uint32_t y = x - (x >= kGfOrder ? kGfOrder : 0u) - (x >= 2 * kGfOrder ? kGfOrder : 0u);
    sh.exp3[x] = x < 3 * kGfOrder ? gexp[y] : 0;
  }
  for (uint32_t x = tid; x < 256; x += nthreads) sh.log[x] = glog[x];
  for (uint32_t s = tid; s < na * k; s += nthreads)
    sh.src[s] = static_cast<uint8_t>(known[a0 * k + s] ^ xor_const);
}

// Step 2: the 3 * na * k sum items, items below na * k the denominators
// (axis it / k, point it % k), the others the output rows (axis r / 2k,
// position r % 2k).  Lane `part` of an item's 4 takes m = part, part + 4,
// ...; a zero difference of a row is counted in bits 16..23 (a row's total
// is at most 128 * 254 < 2^16).
CTT_HD uint32_t rs_dm_partial(const DmSmem& sh, uint32_t lg_k, uint32_t na, uint32_t xor_const,
                              uint32_t it, uint32_t part) {
  const uint32_t k = 1u << lg_k;
  uint32_t acc = 0;
  if (it < na * k) {
    const uint8_t* s = sh.src + (it >> lg_k << lg_k);
    const uint32_t j = it & (k - 1u), sj = s[j];
    for (uint32_t m = part; m < k; m += kDmGroup) acc += sh.log[m == j ? 1u : (sj ^ s[m])];
  } else if (it < 3 * na * k) {
    const uint32_t r = it - na * k;
    const uint8_t* s = sh.src + ((r >> (lg_k + 1)) << lg_k);
    const uint32_t dst = (r & (2 * k - 1u)) ^ xor_const;
    for (uint32_t m = part; m < k; m += kDmGroup) {
      const uint32_t d = dst ^ s[m];
      acc += d ? sh.log[d] : sh.log[1] + (1u << 16);
    }
  }
  return acc;
}

// The item's result from its 4 lanes' sum.
CTT_HD void rs_dm_finish(DmSmem& sh, uint32_t lg_k, uint32_t na, uint32_t it, uint32_t sum) {
  const uint32_t nk = na << lg_k, v = mod255(sum & 0xFFFFu);
  if (it < nk) {
    sh.denom[it] = static_cast<uint8_t>(v);
  } else if (it < 3 * nk) {
    sh.row_log[it - nk] = static_cast<uint8_t>(v);
    sh.row_zero[it - nk] = (sum >> 16) ? 1 : 0;
  }
}

// Step 3, item q of the block's D: W = min(16, k) bytes of one row, bytes
// q*W .. of the block's na * 2k * k (row r = q*W / k, columns from q*W %
// k), written to D at the block's first axis.
template <uint32_t W>
CTT_HD void rs_dm_item(const DmSmem& sh, uint8_t* Db, uint32_t lg_k, uint32_t xor_const,
                       uint32_t q) {
  constexpr uint32_t NW = (W + 3) / 4;  // words of the run
  const uint32_t k = 1u << lg_k, b0 = q * W, r = b0 >> lg_k, j0 = b0 & (k - 1u);
  const uint32_t dst = (r & (2 * k - 1u)) ^ xor_const, axis = (r >> (lg_k + 1)) << lg_k;
  const uint8_t* s = sh.src + axis + j0;
  const uint8_t* dn = sh.denom + axis + j0;
  const uint32_t base = sh.row_log[r] + 2 * kGfOrder;
  const bool zero = sh.row_zero[r] != 0;
  uint32_t sw[NW], dw[NW], ow[NW] = {};  // the run's points and denominators, aligned to W
#ifdef __CUDA_ARCH__
  if constexpr (W == 16) {  // one 16-byte load each
    const uint4 a = *reinterpret_cast<const uint4*>(s), b = *reinterpret_cast<const uint4*>(dn);
    sw[0] = a.x; sw[1] = a.y; sw[2] = a.z; sw[3] = a.w;
    dw[0] = b.x; dw[1] = b.y; dw[2] = b.z; dw[3] = b.w;
  } else
#endif
  {
#pragma unroll
    for (uint32_t w = 0; w < NW; ++w) {
      sw[w] = W >= 4 ? ld32(s + 4 * w) : (W == 2 ? ld16(s) : s[0]);
      dw[w] = W >= 4 ? ld32(dn + 4 * w) : (W == 2 ? ld16(dn) : dn[0]);
    }
  }
#pragma unroll
  for (uint32_t e = 0; e < W; ++e) {
    const uint32_t sh8 = 8 * (e & 3u);
    const uint32_t d = dst ^ ((sw[e >> 2] >> sh8) & 0xFFu);
    const uint32_t lagrange = sh.exp3[base - sh.log[d] - ((dw[e >> 2] >> sh8) & 0xFFu)];
    ow[e >> 2] |= (zero ? (d == 0 ? 1u : 0u) : lagrange) << sh8;
  }
  uint8_t* o = Db + b0;
#ifdef __CUDA_ARCH__
  if constexpr (W == 16) {
    *reinterpret_cast<uint4*>(o) = make_uint4(ow[0], ow[1], ow[2], ow[3]);
  } else if constexpr (W == 8) {
    *reinterpret_cast<uint2*>(o) = make_uint2(ow[0], ow[1]);
  } else if constexpr (W == 4) {
    *reinterpret_cast<uint32_t*>(o) = ow[0];
  } else if constexpr (W == 2) {
    st16(o, ow[0]);
  } else {
    o[0] = static_cast<uint8_t>(ow[0]);
  }
#else
  for (uint32_t e = 0; e < W; ++e) o[e] = static_cast<uint8_t>(ow[e >> 2] >> (8 * (e & 3u)));
#endif
}

// Step 3, thread tid of nthreads: its items q = tid, tid + nthreads, ...
template <uint32_t W>
CTT_HD void rs_dm_items(const DmSmem& sh, uint8_t* Db, uint32_t lg_k, uint32_t na,
                        uint32_t xor_const, uint32_t tid, uint32_t nthreads) {
  const uint32_t items = (na << (2 * lg_k + 1)) / W;
  for (uint32_t q = tid; q < items; q += nthreads) rs_dm_item<W>(sh, Db, lg_k, xor_const, q);
}

CTT_HD void rs_dm_write(const DmSmem& sh, uint8_t* Db, uint32_t lg_k, uint32_t na,
                        uint32_t xor_const, uint32_t tid, uint32_t nthreads) {
  switch (lg_k) {
    case 0: rs_dm_items<1>(sh, Db, lg_k, na, xor_const, tid, nthreads); break;
    case 1: rs_dm_items<2>(sh, Db, lg_k, na, xor_const, tid, nthreads); break;
    case 2: rs_dm_items<4>(sh, Db, lg_k, na, xor_const, tid, nthreads); break;
    case 3: rs_dm_items<8>(sh, Db, lg_k, na, xor_const, tid, nthreads); break;
    default: rs_dm_items<16>(sh, Db, lg_k, na, xor_const, tid, nthreads); break;
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
