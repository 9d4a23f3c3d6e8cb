// The GF(2) bit-GEMM of the Reed-Solomon kernels (K5 rs_extend.cu, K8b
// rs_decode.cu), as per-lane pieces shared with the g++ CPU twin
// (cpu_twin.cpp), and, for nvcc, the block pipeline that runs them.
//
// The map, per axis: n_in input shares x_j of 512 bytes give n_out outputs
// y_i = XOR_j C[i][j] * x_j over GF(256) in the codec's field (C is the
// encode matrix E for K5, E's shard slice for K9a, rows of a decode matrix
// D for K8b).  Lifted to GF(2) it is the JAX package's integer GEMM
// (celestia_tpu/ops/rs.py:52 `matmul_gf2`):
//   bit s of y_i[p] = (sum_{j,t} G[(i,s),(j,t)] * bit t of x_j[p]) & 1,
//   G[(i,s),(j,t)] = bit s of (C[i][j] * 2^t)      (gf256.bit_expand_matrix)
// M = 8 n_out rows (i,s), K = 8 n_in columns (j,t), N = the axes' bytes.
//
// Here it runs on the int8 tensor cores as
// mma.sync.m16n8k32.row.col.s32.u8.u8.s32, G's rows as A and the data bits
// as B, both built in registers; neither the bit planes nor G touch HBM.
//
// * Operand scaling.  A's byte for column (j,t) holds G * 2^(7-t) and B's
//   byte for (j,t) holds (bit t of x_j) * 2^t, so every product is 0 or
//   128 and the parity of a row sum is bit 7 of the int32 accumulator (sums
//   reach 128 * 8 * 128 = 2^17).  Each operand register is then one byte
//   replicated four times (PRMT) and one AND: B's bytes keep their bit t in
//   place, A's are stored bit-reversed.
// * K order.  A 32-deep k-step covers four inputs j0 + q (q = 0..3), bit
//   planes 0-3 in k = 4q + e and 4-7 in k = 16 + 4q + e: lane (g, q) of the
//   fragment layouts then owns input j0 + q in both operands.
// * M order.  A warp holds 4 m-tiles of 16 rows: row g of m-tile mt is
//   output g, bit 2mt, row g + 8 output g, bit 2mt + 1.  Lane (g, q) so
//   accumulates all 8 bits of output g and packs its bytes alone.
// * N order.  A warp covers 64 bytes of an axis as 8 n-tiles: column c of
//   n-tile nt is byte 8c + nt.  Lane (g, q) reads B from the 8 bytes
//   8g..8g+7 of its input (one byte per n-tile) and ends with bytes 16q ..
//   16q + 15 of output g: one 16-byte store.  Each input byte is read by
//   one lane only, so it goes from global memory straight to registers,
//   one chunk of 16 inputs ahead of its use: the main loop needs no shared
//   staging and no barrier.
// * Coefficients.  The block prologue builds the product table
//   P[c][t] = c * 2^t from the codec's exp/log tables, kept bit-transposed
//   and bit-reversed as R[c][s] (bit 7-t of R[c][s] = bit s of P[c][t]),
//   then expands each output group's coefficients C[i][j] (8 outputs, up to
//   kGf2MaxGroups groups a block) once into the m-tiles' A fragments, from
//   the rows R[C[i][j]] (64 KiB a group at k = 128, in dynamic shared
//   memory): each coefficient is one expansion item, loaded straight into
//   a register.  The main loop reads each A fragment with one 16-byte load
//   and spends its ALU work on B alone.
#pragma once

#include <stdint.h>
#include <string.h>

#include "sha256.cuh"  // CTT_HD

namespace ctt {

constexpr uint32_t kGf2Share = 512;             // bytes of an axis position
constexpr uint32_t kGf2Outputs = 8;             // outputs (64 rows of G) a group
constexpr uint32_t kGf2Mt = 4;                  // m-tiles a warp
constexpr uint32_t kGf2Nt = 8;                  // n-tiles a warp
constexpr uint32_t kGf2WarpBytes = 8 * kGf2Nt;  // bytes of an axis a warp covers
constexpr uint32_t kGf2Warps = kGf2Share / kGf2WarpBytes;
constexpr uint32_t kGf2Threads = 32 * kGf2Warps;
constexpr uint32_t kGf2Chunk = 16;              // inputs a chunk (4 k-steps)
constexpr uint32_t kGf2MaxInputs = 128;
constexpr uint32_t kGf2MaxGroups = 3;           // output groups a decode block holds
constexpr uint32_t kGf2TargetBlocks = 512;      // ~4 waves of one block per SM

// Row c of the bit-transposed product table: r[s] has bit 7 - t set when
// bit s of c * 2^t is, products taken in the field of the codec's tables
// (gexp uint8[512], glog uint8[256]; a product is exp[log a + log b]).
CTT_HD void gf2_product_row(uint32_t c, const uint8_t* gexp, const uint8_t* glog, uint8_t r[8]) {
  uint32_t p[8];
#pragma unroll
  for (uint32_t t = 0; t < 8; ++t) p[t] = c ? gexp[glog[c] + glog[1u << t]] : 0u;
#pragma unroll
  for (uint32_t s = 0; s < 8; ++s) {
    uint32_t v = 0;
    for (uint32_t t = 0; t < 8; ++t) v |= ((p[t] >> s) & 1u) << (7u - t);
    r[s] = static_cast<uint8_t>(v);
  }
}

// Inputs padded to whole chunks.  Every chunk runs its 4 k-steps; the
// padded inputs load as zeros and have zero coefficients.
CTT_HD uint32_t gf2_chunks(uint32_t n_in) { return (n_in + kGf2Chunk - 1) / kGf2Chunk; }

// Byte e of x in all four bytes (one PRMT on the card).
CTT_HD uint32_t gf2_splat(uint32_t x, uint32_t e) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, 0u, e * 0x1111u);
#else
  return ((x >> (8u * e)) & 0xFFu) * 0x01010101u;
#endif
}

// The expanded A fragments of a group: for chunk c, k-step kk, m-tile mt
// and lane, the lane's 4 registers, 16 bytes, so that a warp's load of one
// m-tile is 512 contiguous bytes.
CTT_HD uint32_t gf2_frag_offset(uint32_t c, uint32_t kk, uint32_t mt, uint32_t lane) {
  return (((c * 4u + kk) * kGf2Mt + mt) * 32u + lane) * 16u;
}
CTT_HD uint32_t gf2_frag_bytes(uint32_t n_in) { return gf2_frag_offset(gf2_chunks(n_in), 0, 0, 0); }

// Shared memory of a block holding `groups` groups: the codec's exp (512)
// and log (256) tables, the product table (2 KiB), then the groups' A
// fragments.
CTT_HD uint32_t gf2_smem_bytes(uint32_t n_in, uint32_t groups) {
  return 512u + 256u + 2048u + groups * gf2_frag_bytes(n_in);
}

// Expansion item `item` = (chunk c, k-step kk, lane (g, q)) of a group holds
// the lane's A fragments of the 4 m-tiles, all from one coefficient: that
// of the group's output o = g for input j = 16c + 4kk + q.
CTT_HD void gf2_item_coef(uint32_t item, uint32_t* o, uint32_t* j) {
  const uint32_t c = item / 128u, kk = (item / 32u) % 4u, lane = item % 32u;
  *o = lane / 4u;
  *j = c * kGf2Chunk + 4u * kk + lane % 4u;
}

// Item `item` of a group from its coefficient cv: row g of m-tile mt is bit
// 2mt, row g + 8 bit 2mt + 1; a0/a1 hold planes 0-3 (byte e: G * 2^(7-e)),
// a2/a3 planes 4-7 (byte e: G * 2^(3-e)), from R's row for cv (8 bytes,
// s = 0..7).
CTT_HD void gf2_expand_item(uint32_t cv, const uint8_t* prod, uint8_t* frags, uint32_t item) {
  const uint32_t c = item / 128u, kk = (item / 32u) % 4u, lane = item % 32u;
  uint32_t r[2];
#ifdef __CUDA_ARCH__
  const uint2 v = *reinterpret_cast<const uint2*>(prod + 8u * cv);
  r[0] = v.x, r[1] = v.y;
#else
  memcpy(r, prod + 8u * cv, 8);
#endif
#pragma unroll
  for (uint32_t mt = 0; mt < kGf2Mt; ++mt) {
    const uint32_t even = gf2_splat(r[mt / 2], 2 * (mt % 2));
    const uint32_t odd = gf2_splat(r[mt / 2], 2 * (mt % 2) + 1);
    const uint32_t a[4] = {even & 0x10204080u, odd & 0x10204080u, even & 0x01020408u,
                           odd & 0x01020408u};
    uint8_t* p = frags + gf2_frag_offset(c, kk, mt, lane);
#ifdef __CUDA_ARCH__
    *reinterpret_cast<uint4*>(p) = make_uint4(a[0], a[1], a[2], a[3]);
#else
    memcpy(p, a, 16);
#endif
  }
}

// A lane's A fragment of m-tile mt at k-step kk of chunk c.
CTT_HD void gf2_lane_afrag(const uint8_t* frags, uint32_t c, uint32_t kk, uint32_t mt,
                           uint32_t lane, uint32_t a[4]) {
  const uint8_t* p = frags + gf2_frag_offset(c, kk, mt, lane);
#ifdef __CUDA_ARCH__
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
#else
  memcpy(a, p, 16);
#endif
}

// Lane (g, q) of warp `warp`, chunk c of tile `tile`: for each k-step kk the
// 8 bytes from 8g of the warp's 64 bytes of input j = 16c + 4kk + q, zeros
// past n_in (the padded rows of K, whose coefficients are zero too).
template <class Axes>
CTT_HD void gf2_lane_chunk(const Axes& ax, uint32_t tile, uint32_t n_in, uint32_t c,
                           uint32_t warp, uint32_t lane, uint32_t x[4][2]) {
#pragma unroll
  for (uint32_t kk = 0; kk < 4; ++kk) {
    const uint32_t j = c * kGf2Chunk + 4u * kk + lane % 4u;
    if (j >= n_in) {
      x[kk][0] = x[kk][1] = 0;
      continue;
    }
    const uint8_t* p = ax.src(tile, j) + warp * kGf2WarpBytes + 8u * (lane / 4u);
#ifdef __CUDA_ARCH__
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    x[kk][0] = v.x, x[kk][1] = v.y;
#else
    memcpy(x[kk], p, 8);
#endif
  }
}

// B fragments of the lane's 8 n-tiles at one k-step: byte nt of x is the
// lane's column of n-tile nt; b0 planes 0-3 (byte e: bit e in place), b1
// planes 4-7.
CTT_HD void gf2_b_frags(const uint32_t x[2], uint32_t b[kGf2Nt][2]) {
#pragma unroll
  for (uint32_t nt = 0; nt < kGf2Nt; ++nt) {
    const uint32_t v = gf2_splat(x[nt / 4], nt % 4);
    b[nt][0] = v & 0x08040201u;
    b[nt][1] = v & 0x80402010u;
  }
}

// Byte 0 of each of a, b, c, d, in that order (three PRMTs on the card).
CTT_HD uint32_t gf2_low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
#ifdef __CUDA_ARCH__
  return __byte_perm(__byte_perm(a, b, 0x0040u), __byte_perm(c, d, 0x0040u), 0x5410u);
#else
  return (a & 0xFFu) | (b & 0xFFu) << 8 | (c & 0xFFu) << 16 | (d & 0xFFu) << 24;
#endif
}

// The lane's 16 output bytes (from 16q of the warp's 64) from its
// accumulators: byte 8h + nt is column 2q + h of n-tile nt; bit 2mt comes
// from c[h] of m-tile mt (row g), bit 2mt + 1 from c[2 + h] (row g + 8).
// Every product is 0 or 128, so an accumulator's low byte is 0x80 or 0:
// word w gathers, per bit s, the low bytes of its 4 columns and shifts the
// 0x80s down to bit s.
CTT_HD void gf2_pack(const int32_t acc[kGf2Mt][kGf2Nt][4], uint32_t out[4]) {
#pragma unroll
  for (uint32_t w = 0; w < 4; ++w) {
    const uint32_t h = w / 2, nt = 4 * (w % 2);
    uint32_t v = 0;
#pragma unroll
    for (uint32_t s = 0; s < 8; ++s) {
      const uint32_t mt = s / 2, r = h + 2 * (s % 2);
      v |= gf2_low_bytes(static_cast<uint32_t>(acc[mt][nt][r]),
                         static_cast<uint32_t>(acc[mt][nt + 1][r]),
                         static_cast<uint32_t>(acc[mt][nt + 2][r]),
                         static_cast<uint32_t>(acc[mt][nt + 3][r])) >> (7 - s);
    }
    out[w] = v;
  }
}

// Axes per encode block: the fewest that still leave kGf2TargetBlocks
// blocks (at most 8), so a block's prologue serves several axes when the
// grid is large.
CTT_HD uint32_t gf2_axes_per_block(uint32_t blocks_per_axis, uint32_t n_axes) {
  uint32_t apb = 1;
  while (apb < 8 && blocks_per_axis * ((n_axes + 2 * apb - 1) / (2 * apb)) >= kGf2TargetBlocks)
    apb *= 2;
  return apb;
}

// Output groups per decode block, on the same rule, at most kGf2MaxGroups.
CTT_HD uint32_t gf2_groups_per_block(uint32_t groups, uint32_t n_axes) {
  uint32_t gpb = 1;
  while (gpb < kGf2MaxGroups && gpb < groups &&
         n_axes * ((groups + gpb) / (gpb + 1)) >= kGf2TargetBlocks)
    ++gpb;
  return gpb;
}

// The tiles of an encode block (K5, K5b, the row pass, K9a): tile a is
// axis a of the block, its input j at in + a*as + j*ps, its output o at
// out + a*oas + o*ops (in and out already at the block's first axis and,
// for out, its first output); every tile has the one coefficient group.
struct Gf2EncodeAxes {
  const uint8_t* in;
  uint8_t* out;
  uint64_t as, ps, oas, ops;
  uint32_t nout;
  CTT_HD const uint8_t* src(uint32_t a, uint32_t j) const { return in + a * as + j * ps; }
  CTT_HD uint8_t* dst(uint32_t a, uint32_t o) const { return out + a * oas + o * ops; }
  CTT_HD uint32_t group(uint32_t) const { return 0; }
  CTT_HD uint32_t outputs(uint32_t) const { return nout; }
};

// The tiles of a decode block (K8b): tile t is output group t of the
// block's one axis at base; input j is its known position kpos[j], output
// o of the tile its unknown position opos[8t + o] (opos at the block's
// first output); the block has n_out unknown positions from there on.
struct Gf2DecodeAxes {
  uint8_t* base;
  uint64_t ps;
  const uint8_t* kpos;
  const uint8_t* opos;
  uint32_t n_out;
  CTT_HD const uint8_t* src(uint32_t, uint32_t j) const { return base + kpos[j] * ps; }
  CTT_HD uint8_t* dst(uint32_t t, uint32_t o) const {
    return base + opos[t * kGf2Outputs + o] * ps;
  }
  CTT_HD uint32_t group(uint32_t t) const { return t; }
  CTT_HD uint32_t outputs(uint32_t t) const {
    const uint32_t left = n_out - t * kGf2Outputs;
    return left < kGf2Outputs ? left : kGf2Outputs;
  }
};

#ifdef __CUDACC__

// One m16n8k32 product of the warp, d += a * b.
__device__ __forceinline__ void gf2_mma(int32_t d[4], const uint32_t a[4], const uint32_t b[2]) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
}

#endif  // __CUDACC__

#ifndef __CUDA_ARCH__

// Host emulation of mma.sync.m16n8k32.row.col.s32.u8.u8.s32 over a warp's
// 32 lanes, following the PTX ISA's fragment layouts (lane = 4g + q):
//   A (16 x 32, row): a[i] byte e is A[g + 8(i & 1)][4q + e + 16(i >> 1)]
//   B (32 x 8, col):  b[i] byte e is B[4q + e + 16i][g]
//   C/D (16 x 8):     d[i] is D[g + 8(i >> 1)][2q + (i & 1)]
inline void gf2_mma_warp(int32_t d[32][4], const uint32_t a[32][4], const uint32_t b[32][2]) {
  uint32_t A[16][32], B[32][8];
  for (uint32_t lane = 0; lane < 32; ++lane) {
    const uint32_t g = lane / 4, q = lane % 4;
    for (uint32_t i = 0; i < 4; ++i)
      for (uint32_t e = 0; e < 4; ++e)
        A[g + 8 * (i & 1)][4 * q + e + 16 * (i >> 1)] = (a[lane][i] >> (8 * e)) & 0xFFu;
    for (uint32_t i = 0; i < 2; ++i)
      for (uint32_t e = 0; e < 4; ++e) B[4 * q + e + 16 * i][g] = (b[lane][i] >> (8 * e)) & 0xFFu;
  }
  for (uint32_t lane = 0; lane < 32; ++lane) {
    const uint32_t g = lane / 4, q = lane % 4;
    for (uint32_t i = 0; i < 4; ++i) {
      const uint32_t m = g + 8 * (i >> 1), n = 2 * q + (i & 1);
      uint32_t sum = 0;
      for (uint32_t kx = 0; kx < 32; ++kx) sum += A[m][kx] * B[kx][n];
      d[lane][i] += static_cast<int32_t>(sum);
    }
  }
}

#endif  // __CUDA_ARCH__

#ifdef __CUDACC__

// The regions of a block's dynamic shared memory (gf2_smem_bytes).
struct Gf2Smem {
  uint8_t* exp;
  uint8_t* log;
  uint8_t* prod;   // R[c][s]
  uint8_t* frags;  // group t at t * frag_bytes
  uint32_t frag_bytes;
  __device__ Gf2Smem(uint8_t* base, uint32_t n_in)
      : exp(base), log(base + 512), prod(base + 768), frags(base + 2816),
        frag_bytes(gf2_frag_bytes(n_in)) {}
};

// Block prologue, part 1: the codec's tables into shared memory (every
// thread), then, after a barrier, part 2 builds the product table.
__device__ __forceinline__ void gf2_load_tables(const Gf2Smem& sh, const uint8_t* gexp,
                                                const uint8_t* glog) {
  for (uint32_t i = threadIdx.x; i < 512u; i += blockDim.x) sh.exp[i] = gexp[i];
  for (uint32_t i = threadIdx.x; i < 256u; i += blockDim.x) sh.log[i] = glog[i];
}

__device__ __forceinline__ void gf2_build_products(const Gf2Smem& sh) {
  for (uint32_t c = threadIdx.x; c < 256u; c += blockDim.x)
    gf2_product_row(c, sh.exp, sh.log, sh.prod + 8 * c);
}

// Block prologue, in two parts: gf2_fetch_coef loads thread threadIdx.x's
// coefficients C(o, j) of `groups` output groups (zero for o >= n_out or
// j >= n_in), one per expansion item it owns, all before any is used so
// that their global loads overlap; once the product table is built (and a
// barrier), gf2_expand writes the items' A fragments (a barrier follows).
constexpr uint32_t kGf2ItemsPerThread =
    kGf2MaxGroups * (kGf2MaxInputs / kGf2Chunk) * 128u / kGf2Threads;

template <class Coef>
__device__ __forceinline__ void gf2_fetch_coef(uint32_t groups, uint32_t n_out, uint32_t n_in,
                                               const Coef& C, uint32_t v[kGf2ItemsPerThread]) {
  const uint32_t items = gf2_chunks(n_in) * 128u;
#pragma unroll
  for (uint32_t i = 0; i < kGf2ItemsPerThread; ++i) {
    const uint32_t idx = threadIdx.x + i * kGf2Threads;
    uint32_t o, j;
    gf2_item_coef(idx % items, &o, &j);
    o += idx / items * kGf2Outputs;
    v[i] = idx < groups * items && o < n_out && j < n_in ? C(o, j) : 0u;
  }
}

__device__ __forceinline__ void gf2_expand(const Gf2Smem& sh, uint32_t groups, uint32_t n_in,
                                           const uint32_t v[kGf2ItemsPerThread]) {
  const uint32_t items = gf2_chunks(n_in) * 128u;
#pragma unroll
  for (uint32_t i = 0; i < kGf2ItemsPerThread; ++i) {
    const uint32_t idx = threadIdx.x + i * kGf2Threads;
    if (idx < groups * items)
      gf2_expand_item(v[i], sh.prod, sh.frags + idx / items * sh.frag_bytes, idx % items);
  }
}

// The GEMM of a block over n_tiles tiles of `ax` (axes, or output groups of
// one axis), n_in inputs each, with the tiles' A fragments expanded and
// `first`, the lane's inputs of tile 0's chunk 0 (gf2_lane_chunk), loaded.
// Each lane loads the next chunk's inputs -- of this tile or the next --
// before multiplying the current one.
template <class Axes>
__device__ __forceinline__ void gf2_gemm(const Axes& ax, uint32_t n_tiles, uint32_t n_in,
                                         const Gf2Smem& sh, const uint32_t first[4][2]) {
  const uint32_t warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t g = lane / 4, q = lane % 4, n_chunks = gf2_chunks(n_in);
  uint32_t cur[4][2], next[4][2];
#pragma unroll
  for (uint32_t kk = 0; kk < 4; ++kk) cur[kk][0] = first[kk][0], cur[kk][1] = first[kk][1];
  int32_t acc[kGf2Mt][kGf2Nt][4];
  uint32_t tile = 0, c = 0;
  while (tile < n_tiles) {
    uint32_t ntile = tile, nc = c + 1;
    if (nc == n_chunks) nc = 0, ++ntile;
    if (ntile < n_tiles) gf2_lane_chunk(ax, ntile, n_in, nc, warp, lane, next);
    if (c == 0) {
#pragma unroll
      for (uint32_t mt = 0; mt < kGf2Mt; ++mt)
#pragma unroll
        for (uint32_t nt = 0; nt < kGf2Nt; ++nt)
#pragma unroll
          for (uint32_t i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
    }
    const uint8_t* frags = sh.frags + ax.group(tile) * sh.frag_bytes;
#pragma unroll
    for (uint32_t kk = 0; kk < 4; ++kk) {
      uint32_t af[kGf2Mt][4], bf[kGf2Nt][2];
#pragma unroll
      for (uint32_t mt = 0; mt < kGf2Mt; ++mt) gf2_lane_afrag(frags, c, kk, mt, lane, af[mt]);
      gf2_b_frags(cur[kk], bf);
#pragma unroll
      for (uint32_t mt = 0; mt < kGf2Mt; ++mt)
#pragma unroll
        for (uint32_t nt = 0; nt < kGf2Nt; ++nt) gf2_mma(acc[mt][nt], af[mt], bf[nt]);
    }
    if (nc == 0 && g < ax.outputs(tile)) {  // the tile's last chunk
      uint32_t v[4];
      gf2_pack(acc, v);
      *reinterpret_cast<uint4*>(ax.dst(tile, g) + warp * kGf2WarpBytes + 16 * q) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
#pragma unroll
    for (uint32_t kk = 0; kk < 4; ++kk) cur[kk][0] = next[kk][0], cur[kk][1] = next[kk][1];
    tile = ntile, c = nc;
  }
}

#endif  // __CUDACC__

}  // namespace ctt
