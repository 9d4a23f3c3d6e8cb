// K5 under leopard-ff8: Leopard's O(k log k) encode of one axis, as
// per-thread code shared by the kernel (rs_leopard.cu) and the g++ CPU twin
// (cpu_twin.cpp), and the function that builds its skew tables; below, K9a's
// pruned encode of a row shard's column partial (rs_leopard_partial.cu).
//
// The map, per axis of k data shares (Leopard's high-rate layout: data at
// the coset k ^ [0, k), parity at the coset [0, k)):
//   parity = FFT_coset0(IFFT_cosetk(data))
// exactly as native/celestia_native.cpp `leo_encode` (:840) computes it,
// with `leo_ifft` (:820) and `leo_fft` (:803).  Layer j (dist = 2^j) pairs
// positions i and i + dist inside groups of 2 dist from b0; the group's
// skew is LEO_SKEW[j][coset ^ b0] (`leo_init` :738-753):
//   IFFT butterfly  b ^= a;  a ^= skew * b
//   FFT butterfly   a ^= skew * b;  b ^= a
// The FFT's group b0 = 0 has skew W_j(0) / W_j(2^j) = 0, so its butterflies
// are b ^= a alone (`leo_mul_add` returns at c = 0).  Every byte position of
// a share is its own codeword, so two threads own one 4-byte word column of
// an axis -- the word at the same offset of each of the k shares -- k/2
// words each in registers, for all 2 log2 k layers (see the cross step
// below); the layers are unrolled (templated on log2 k), so every register
// index is a constant.
//
// The multiply by a warp-uniform skew s, 4 bytes at once: split each byte
// into bits 0-2, 3-5 and 6-7; by linearity s * x is
//   Ta[x & 7] ^ Tb[(x >> 3) & 7] ^ Tc[x >> 6],
// Ta[v] = s*v, Tb[v] = s*(v << 3) (8 entries, 2 words each), Tc[v] =
// s*(v << 6) (4 entries, 1 word): three byte permutes (PRMT) whose
// selector nibbles are the 4 bytes' fields.  The fields are brought to
// nibbles 0-3 by one byte permute of the word (bytes 0, 2, 1, 3) and one
// shift-add per field: (f + (f >> 12)) puts byte 0, 1, 2, 3's field at
// nibble 0, 2, 1, 3 of the permuted word, i.e. at nibble 0, 1, 2, 3 of
// the original.  A group's tables are 6 words (leo_group_tables), built
// on the host from the codec's field tables and staged in shared memory.
#pragma once

#include <stdint.h>
#include <string.h>

#include "sha256.cuh"  // CTT_HD, prmt

namespace ctt {

constexpr uint32_t kLeoShare = 512;                // bytes of an axis position
constexpr uint32_t kLeoWords = kLeoShare / 4;      // word columns of an axis
constexpr uint32_t kLeoMaxLogK = 7;                // k <= 128
constexpr uint32_t kLeoGroupWords = 6;             // Ta (2), Tb (2), Tc (1), pad

// Skew groups of one axis's encode: k - 1 in the IFFT, k - 1 in the FFT.
CTT_HD uint32_t leo_groups(uint32_t k) { return k > 1 ? 2 * (k - 1) : 0; }
CTT_HD uint32_t leo_table_bytes(uint32_t k) { return leo_groups(k) * kLeoGroupWords * 4; }

// Group g of layer j of transform `fft` (0: the IFFT at coset k, 1: the
// FFT at coset 0): layer j has k >> (j + 1) groups, k - (k >> j) before it.
CTT_HD uint32_t leo_group(uint32_t k, uint32_t fft, uint32_t j, uint32_t g) {
  return fft * (k - 1) + (k - (k >> j)) + g;
}

// a * b in the codec's field (gexp uint8[512], glog uint8[256]).
CTT_HD uint32_t leo_field_mul(uint32_t a, uint32_t b, const uint8_t* gexp, const uint8_t* glog) {
  return a && b ? gexp[glog[a] + glog[b]] : 0u;
}

// skew[j][x] = W_j(x) / W_j(2^j) with the subspace vanishing polynomials
// W_0(x) = x, W_{j+1}(x) = W_j(x) * W_j(x ^ 2^j), as `leo_init` builds them.
CTT_HD void leo_skews(const uint8_t* gexp, const uint8_t* glog, uint8_t skew[8][256]) {
  uint8_t W[256], Wn[256];
  for (uint32_t x = 0; x < 256; ++x) W[x] = static_cast<uint8_t>(x);
  for (uint32_t j = 0; j < 8; ++j) {
    const uint32_t inv = gexp[255u - glog[W[1u << j]]];
    for (uint32_t x = 0; x < 256; ++x)
      skew[j][x] = static_cast<uint8_t>(leo_field_mul(W[x], inv, gexp, glog));
    if (j < 7) {
      for (uint32_t x = 0; x < 256; ++x)
        Wn[x] = static_cast<uint8_t>(leo_field_mul(W[x], W[x ^ (1u << j)], gexp, glog));
      memcpy(W, Wn, sizeof W);
    }
  }
}

// The 6 words of the multiply by s = gexp[e] (s != 0, e < 256): the bytes
// Ta[0..7] = s*v, Tb[0..7] = s*(v << 3), Tc[0..3] = s*(v << 6), then a
// zero word (glog[0] is never read: its entry differs between tables).
CTT_HD void leo_mul_tables_log(uint32_t e, const uint8_t* gexp, const uint8_t* glog,
                               uint32_t* out) {
  uint32_t w[kLeoGroupWords] = {};
  for (uint32_t i = 0; i < 20; ++i) {
    const uint32_t v = i < 8 ? i : (i < 16 ? (i - 8) << 3 : (i - 16) << 6);
    if (v) w[i / 4] |= static_cast<uint32_t>(gexp[e + glog[v]]) << (8 * (i % 4));
  }
  for (uint32_t i = 0; i < kLeoGroupWords; ++i) out[i] = w[i];
}

// The same for any s, zero included (all six words zero).
CTT_HD void leo_mul_tables(uint32_t s, const uint8_t* gexp, const uint8_t* glog, uint32_t* out) {
  if (s) {
    leo_mul_tables_log(glog[s], gexp, glog, out);
  } else {
    for (uint32_t i = 0; i < kLeoGroupWords; ++i) out[i] = 0;
  }
}

// The 6 words of each group of a k-share encode (leo_group order): the
// tables of the group's skew.
CTT_HD void leo_group_tables(const uint8_t* gexp, const uint8_t* glog, uint32_t k, uint32_t* out) {
  uint8_t skew[8][256];
  leo_skews(gexp, glog, skew);
  const uint32_t log_k = log2_exact(k);
  for (uint32_t fft = 0; fft < 2; ++fft)
    for (uint32_t j = 0; j < log_k; ++j)
      for (uint32_t g = 0; g < (k >> (j + 1)); ++g)
        leo_mul_tables(skew[j][((fft ? 0u : k) ^ (g << (j + 1))) & 255u], gexp, glog,
                       out + kLeoGroupWords * leo_group(k, fft, j, g));
}

// A group's tables from `tab` (shared memory on the card): t[0..1] Ta,
// t[2..3] Tb, t[4] Tc.
CTT_HD void leo_load_group(const uint32_t* tab, uint32_t t[5]) {
#ifdef __CUDA_ARCH__
  const uint2 a = reinterpret_cast<const uint2*>(tab)[0];
  const uint2 b = reinterpret_cast<const uint2*>(tab)[1];
  t[0] = a.x, t[1] = a.y, t[2] = b.x, t[3] = b.y, t[4] = tab[4];
#else
  memcpy(t, tab, 5 * sizeof(uint32_t));
#endif
}

// A group's tables, read anew at each use (volatile loads):
// the same words are not kept in registers across a thread's other words
// (K8b's Leopard decode, rs_leopard_decode.cuh: at 64 words a thread that
// was the difference between a spill and none).
CTT_HD void leo_load_group_fresh(const uint32_t* tab, uint32_t t[5]) {
  const volatile uint32_t* v = tab;
#pragma unroll
  for (uint32_t i = 0; i < 5; ++i) t[i] = v[i];
}

// s * x for each of the 4 bytes of x, s the skew whose tables are t.
CTT_HD uint32_t leo_mul_word(uint32_t x, const uint32_t t[5]) {
  const uint32_t v = prmt(x, 0u, 0x3120u);  // bytes 0, 2, 1, 3
  const uint32_t a = v & 0x07070707u;
  const uint32_t b = (v >> 3) & 0x07070707u;
  const uint32_t c = (v >> 6) & 0x03030303u;
  // a + (a >> 12) == a | (a >> 12): the fields' bits do not meet, and the
  // sum is one LEA.HI
  return prmt(t[0], t[1], a + (a >> 12)) ^ prmt(t[2], t[3], b + (b >> 12)) ^
         prmt(t[4], 0u, c + (c >> 12));
}

// Two threads share a word column (k >= 2): half h holds the words of
// shares h * k/2 .. h * k/2 + k/2 - 1.  Every layer with dist < k/2 pairs
// words of one half.  The two layers with dist = k/2 -- the IFFT's last,
// group 0 with skew s = LEO_SKEW[log2 k - 1][k], and the FFT's first,
// group 0 with skew 0 -- pair word i of half 0 (a) with word i of half 1
// (b), and together they are
//   b1 = b ^ a; a1 = a ^ s*b1; b2 = b1 ^ a1   =>   a2 = a ^ s*(a ^ b), b2 = b ^ s*(a ^ b),
// one exchange of the two halves' words and the same step on each
// (leo_cross_word).  So a half runs its IFFT layers, the cross step, then
// its FFT layers, k/2 words in registers.  Half 0's first group of each of
// its FFT layers has skew 0 too; it multiplies by that group's tables,
// which are zero, so the two halves of a warp run one instruction stream.

// Layer J of the IFFT (FFT = false) or the FFT over part p's W = 2^LOG_W
// words of a column, J < LOG_W: its groups are the layer's groups p * W /
// (2 dist) on, whose tables start at `layer` (the layer's group 0), one
// part's after another; or, with PARTS > 0, group g of every part's side
// by side (part p's at g * PARTS + p: the parts' loads in distinct banks),
// read anew at each use.
template <uint32_t LOG_W, uint32_t J, bool FFT, uint32_t PARTS = 0>
CTT_HD void leo_part_layer(uint32_t (&x)[1u << LOG_W], const uint32_t* layer, uint32_t p) {
  constexpr uint32_t dist = 1u << J, groups = (1u << LOG_W) / (2 * dist);
#pragma unroll
  for (uint32_t g = 0; g < groups; ++g) {
    uint32_t t[5];
    if constexpr (PARTS > 0)
      leo_load_group_fresh(layer + kLeoGroupWords * (g * PARTS + p), t);
    else
      leo_load_group(layer + kLeoGroupWords * (p * groups + g), t);
#pragma unroll
    for (uint32_t m = 0; m < dist; ++m) {
      uint32_t& a = x[2 * dist * g + m];
      uint32_t& b = x[2 * dist * g + m + dist];
      if (FFT) {
        a ^= leo_mul_word(b, t);
        b ^= a;
      } else {
        b ^= a;
        a ^= leo_mul_word(b, t);
      }
    }
  }
}

// Layer J < log2 k - 1 of the encode's IFFT or FFT over half h's k/2 words.
template <uint32_t LOG_K, uint32_t J, bool FFT>
CTT_HD void leo_half_layer(uint32_t (&x)[1u << (LOG_K - 1)], const uint32_t* tab, uint32_t h) {
  leo_part_layer<LOG_K - 1, J, FFT>(x, tab + kLeoGroupWords * leo_group(1u << LOG_K, FFT, J, 0), h);
}

// Half h's IFFT layers J = 0 .. log2 k - 2, and its FFT layers log2 k - 2 .. 0.
template <uint32_t LOG_K, uint32_t J = 0>
CTT_HD void leo_half_ifft(uint32_t (&x)[1u << (LOG_K - 1)], const uint32_t* tab, uint32_t h) {
  if constexpr (J + 1 < LOG_K) {
    leo_half_layer<LOG_K, J, false>(x, tab, h);
    leo_half_ifft<LOG_K, J + 1>(x, tab, h);
  }
}

// The FFT's layers given its own tables `fft` (its k - 1 groups in
// leo_group order from the FFT's first): K5's after its IFFT's, K9a's
// after its shard's (leo_partial_fft_group).
template <uint32_t LOG_K, uint32_t J = LOG_K - 1>
CTT_HD void leo_half_fft_at(uint32_t (&x)[1u << (LOG_K - 1)], const uint32_t* fft, uint32_t h) {
  if constexpr (J > 0) {
    constexpr uint32_t K = 1u << LOG_K;
    leo_part_layer<LOG_K - 1, J - 1, true>(x, fft + kLeoGroupWords * (K - (K >> (J - 1))), h);
    leo_half_fft_at<LOG_K, J - 1>(x, fft, h);
  }
}

template <uint32_t LOG_K>
CTT_HD void leo_half_fft(uint32_t (&x)[1u << (LOG_K - 1)], const uint32_t* tab, uint32_t h) {
  leo_half_fft_at<LOG_K>(x, tab + kLeoGroupWords * ((1u << LOG_K) - 1), h);
}

// The tables of the cross step's skew (the IFFT's last layer, group 0).
CTT_HD const uint32_t* leo_cross_group(const uint32_t* tab, uint32_t k) {
  return tab + kLeoGroupWords * leo_group(k, 0, log2_exact(k) - 1, 0);
}

// The cross step on a word, given the other half's word i.
CTT_HD uint32_t leo_cross_word(uint32_t x, uint32_t peer, const uint32_t t[5]) {
  return x ^ leo_mul_word(x ^ peer, t);
}

// Half h's k/2 words of a word column: the 4 bytes at p + (h * k/2 + i) * stride.
template <uint32_t LOG_K>
CTT_HD void leo_half_load(const uint8_t* p, uint64_t stride, uint32_t h,
                          uint32_t (&x)[1u << (LOG_K - 1)]) {
  constexpr uint32_t H = 1u << (LOG_K - 1);
#pragma unroll
  for (uint32_t i = 0; i < H; ++i) {
    const uint8_t* q = p + (h * H + i) * stride;
#ifdef __CUDA_ARCH__
    x[i] = *reinterpret_cast<const uint32_t*>(q);
#else
    memcpy(&x[i], q, 4);
#endif
  }
}

template <uint32_t LOG_K>
CTT_HD void leo_half_store(uint8_t* p, uint64_t stride, uint32_t h,
                           const uint32_t (&x)[1u << (LOG_K - 1)]) {
  constexpr uint32_t H = 1u << (LOG_K - 1);
#pragma unroll
  for (uint32_t i = 0; i < H; ++i) {
    uint8_t* q = p + (h * H + i) * stride;
#ifdef __CUDA_ARCH__
    *reinterpret_cast<uint32_t*>(q) = x[i];
#else
    memcpy(q, &x[i], 4);
#endif
  }
}

// The axes of one launch: axis a, data share i at in + a*as + i*ps; parity
// share i written to out + a*oas + i*ops.
struct LeoAxisSet {
  const uint8_t* in;
  uint8_t* out;
  uint64_t as, ps, oas, ops;
};

// K9a under leopard-ff8: a shard's column-parity partial (rs_leopard_partial.cu).
// The shard holds data rows j0 .. j0 + m - 1 of each column codeword (m =
// k/R a power of two, j0 a multiple of m); its partial is the parity of
// Leopard's encode of the column with the other k - m data rows zero, so
// the R shards' partials XOR to the parity (the encode is linear).  Layer
// j of the IFFT pairs positions inside aligned groups of 2^(j+1), so:
// - the layers with 2^j < m act inside the shard's block alone: the
//   block's own IFFT, (m/2) log2 m butterflies, with the skews of the
//   block's groups (leo_partial_block_ifft);
// - each later layer doubles the nonzero span, and every one of its 2^j
//   butterflies has one zero operand: with the span in the lower half of
//   its group (bit j of j0 clear) b = a, a ^= s*a; in the upper half a =
//   s*b.  Kept in registers in position order, span word v becomes the
//   lower word s*v ^ (v if bit j of j0 is clear) and the upper word v:
//   one multiply a word (leo_partial_spread);
// - the IFFT's last layer and the FFT's first (group 0, skew 0) fold into
//   one top step, as K5's cross step does, and with one half zero it needs
//   no exchange: the half h that holds the block (bit log2 k - 1 of j0)
//   gets v ^ s*v, the other s*v (leo_partial_top);
// - the FFT over the k parity points is K5's (leo_half_fft_at).
// At k = 128, m = 16 a column takes 32 + 112 + 448 word multiplies against
// a full encode's 896.  Both threads of a word column run the block's IFFT
// and spread on the same m loaded words, which leaves no lane idle and
// needs no shuffle; they part at the top step into K5's halves.  m = k is
// K5's encode (the tables are then K5's).

// Whether (k, m, j0) is no shard the partial kernel takes: k a power of
// two <= 128, m a power of two <= k, j0 a multiple of m with j0 + m <= k.
CTT_HD bool leo_partial_bad_shard(int k, int m, int j0) {
  return k < 1 || log2_exact(static_cast<uint64_t>(k)) > kLeoMaxLogK || m < 1 || m > k ||
         (m & (m - 1)) || j0 < 0 || j0 % m || j0 + m > k;
}

// Skew groups of a shard's partial: the block's m - 1, one a later IFFT
// layer (log2 k - log2 m, the top step's last), then the FFT's k - 1.
CTT_HD uint32_t leo_partial_fft_group(uint32_t k, uint32_t m) {
  return (m - 1) + (log2_exact(k) - log2_exact(m));
}
CTT_HD uint32_t leo_partial_groups(uint32_t k, uint32_t m) {
  return k > 1 ? leo_partial_fft_group(k, m) + (k - 1) : 0;
}
CTT_HD uint32_t leo_partial_table_bytes(uint32_t k, uint32_t m) {
  return leo_partial_groups(k, m) * kLeoGroupWords * 4;
}

// The 6 words of each group of the partial of the shard at j0 (m rows): the
// IFFT's layer j < log2 m has m >> (j + 1) groups (from m - (m >> j)), its
// layer j >= log2 m one (at m - 1 + j - log2 m), each group's skew that of
// its place in the k-share IFFT; then the FFT's k - 1 groups, as K5's.
CTT_HD void leo_partial_tables(const uint8_t* gexp, const uint8_t* glog, uint32_t k, uint32_t m,
                               uint32_t j0, uint32_t* out) {
  uint8_t skew[8][256];
  leo_skews(gexp, glog, skew);
  const uint32_t log_k = log2_exact(k), log_m = log2_exact(m);
  for (uint32_t j = 0; j < log_k; ++j) {
    const uint32_t span = 2u << j, base = j0 & ~(span - 1);
    for (uint32_t g = 0; g < (j < log_m ? m >> (j + 1) : 1u); ++g, out += kLeoGroupWords)
      leo_mul_tables(skew[j][(k ^ (base + g * span)) & 255u], gexp, glog, out);
  }
  for (uint32_t j = 0; j < log_k; ++j)
    for (uint32_t g = 0; g < (k >> (j + 1)); ++g, out += kLeoGroupWords)
      leo_mul_tables(skew[j][(g << (j + 1)) & 255u], gexp, glog, out);
}

// The block's IFFT layers J < log2 m over words 0 .. m - 1 of x.
template <uint32_t LOG_H, uint32_t LOG_M, uint32_t J = 0>
CTT_HD void leo_partial_block_ifft(uint32_t (&x)[1u << LOG_H], const uint32_t* tab) {
  if constexpr (J < LOG_M) {
    constexpr uint32_t M = 1u << LOG_M, dist = 1u << J;
#pragma unroll
    for (uint32_t g = 0; g < M / (2 * dist); ++g) {
      uint32_t t[5];
      leo_load_group(tab + kLeoGroupWords * (M - (M >> J) + g), t);
#pragma unroll
      for (uint32_t i = 0; i < dist; ++i) {
        uint32_t& a = x[2 * dist * g + i];
        uint32_t& b = x[2 * dist * g + i + dist];
        b ^= a;
        a ^= leo_mul_word(b, t);
      }
    }
    leo_partial_block_ifft<LOG_H, LOG_M, J + 1>(x, tab);
  }
}

// IFFT layer J >= log2 m over the span x[0 .. 2^J), into x[0 .. 2^(J+1)):
// `keep` all ones where the span is its group's lower half, else zero.
template <uint32_t LOG_H, uint32_t J>
CTT_HD void leo_partial_spread(uint32_t (&x)[1u << LOG_H], const uint32_t t[5], uint32_t keep) {
#pragma unroll
  for (uint32_t i = 0; i < (1u << J); ++i) {
    const uint32_t v = x[i];
    x[i + (1u << J)] = v;
    x[i] = leo_mul_word(v, t) ^ (v & keep);
  }
}

// The IFFT's layers J = log2 m .. log2 k - 2 of the shard at j0.
template <uint32_t LOG_K, uint32_t LOG_M, uint32_t J = LOG_M>
CTT_HD void leo_partial_spreads(uint32_t (&x)[1u << (LOG_K - 1)], const uint32_t* tab,
                                uint32_t j0) {
  if constexpr (J + 1 < LOG_K) {
    uint32_t t[5];
    leo_load_group(tab + kLeoGroupWords * ((1u << LOG_M) - 1 + J - LOG_M), t);
    leo_partial_spread<LOG_K - 1, J>(x, t, (j0 >> J) & 1u ? 0u : ~0u);
    leo_partial_spreads<LOG_K, LOG_M, J + 1>(x, tab, j0);
  }
}

// The top step on the span of k/2 words: half h's words after the IFFT's
// last layer and the FFT's first.
template <uint32_t LOG_K, uint32_t LOG_M>
CTT_HD void leo_partial_top(uint32_t (&x)[1u << (LOG_K - 1)], const uint32_t* tab, uint32_t j0,
                            uint32_t h) {
  uint32_t t[5];
  leo_load_group(tab + kLeoGroupWords * (((1u << LOG_M) - 1) + (LOG_K - 1 - LOG_M)), t);
  const uint32_t keep = ((j0 >> (LOG_K - 1)) & 1u) == h ? ~0u : 0u;
#pragma unroll
  for (uint32_t i = 0; i < (1u << (LOG_K - 1)); ++i) x[i] = leo_mul_word(x[i], t) ^ (x[i] & keep);
}

// The shard's m words of a word column: the 4 bytes at p + i * stride.
template <uint32_t LOG_H, uint32_t LOG_M>
CTT_HD void leo_partial_load(const uint8_t* p, uint64_t stride, uint32_t (&x)[1u << LOG_H]) {
#pragma unroll
  for (uint32_t i = 0; i < (1u << LOG_M); ++i) {
    const uint8_t* q = p + i * stride;
#ifdef __CUDA_ARCH__
    x[i] = *reinterpret_cast<const uint32_t*>(q);
#else
    memcpy(&x[i], q, 4);
#endif
  }
}

// Half h's k/2 words of a word column's partial before its FFT, m < k:
// the block loaded, its IFFT, the spread, the top step.
template <uint32_t LOG_K, uint32_t LOG_M>
CTT_HD void leo_partial_ifft(const uint8_t* p, uint64_t stride, const uint32_t* tab, uint32_t j0,
                             uint32_t h, uint32_t (&x)[1u << (LOG_K - 1)]) {
  static_assert(LOG_M < LOG_K, "m = k is K5's encode");
  leo_partial_load<LOG_K - 1, LOG_M>(p, stride, x);
  leo_partial_block_ifft<LOG_K - 1, LOG_M>(x, tab);
  leo_partial_spreads<LOG_K, LOG_M>(x, tab, j0);
  leo_partial_top<LOG_K, LOG_M>(x, tab, j0, h);
}

}  // namespace ctt
