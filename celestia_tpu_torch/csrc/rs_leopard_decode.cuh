// K8b under leopard-ff8: Leopard's O(k log k) erasure decode of one axis,
// as per-thread code shared by the kernel (rs_leopard_decode.cu) and the g++
// CPU twin (cpu_twin.cpp), and the function that builds its tables.
//
// The map, per axis of n = 2k positions of which exactly k are known (the
// repair schedule's choice, not every available cell: only then does a
// provided cell that disagrees with the k chosen ones get overwritten and
// flagged), as native/celestia_native.cpp `leo_decode_axis` (:956)
// computes it.  Position p is the point p ^ k; M is the set of the k
// points whose positions are not known ("erased"), E(x) = prod_{m in M}
// (x ^ x_m) their locator:
//   1. W = E(x_j) * r_j at the known points, 0 at the erased ones;
//   2. the IFFT of W over all n points at coset 0 (Leopard's novel basis);
//   3. the formal derivative: coefficient m becomes the sum, over the bits
//      i < log2 n clear in m, of c_i * coefficient m | 2^i (`leo_deriv_init`
//      :906-918 derives c_i);
//   4. the FFT over the n points at coset 0;
//   5. each erased point's value times 1 / E'(x_m), E'(x_m) = prod_{m' in M,
//      m' != m} (x_m ^ x_m'), is the decode; it is written to its position.
// The IFFT's and the FFT's group g of layer j share a skew, LEO_SKEW[j][2^(j+1)
// g] (coset 0), so one table serves both; the top layer's only group has
// skew 0 and is XORs alone.
//
// Every byte position of a share is its own codeword, so a 4-byte word
// column of an axis -- the word at one offset of each of the n positions --
// is decoded alone.  T = 2^C threads own a column (lanes l + (32 / T) t of
// a warp), thread t the W = n/T points t W .. t W + W - 1 in registers.
// The layers with dist < W run in a thread (leo_part_layer); the C with
// dist >= W, and the derivative's C levels of those bits, pair thread t
// with t ^ 2^b by a shuffle a word.  The derivative runs in place in
// ascending order of a thread's words: word m reads only words above m of
// its own (not yet overwritten) and its partners' word m (exchanged before
// any is overwritten).
//
// The per-position scalars are uniform over a position's word columns: a
// block first computes the locator of its axis in the log domain (L[j] =
// sum over m in M, m != j, of log(x_j ^ x_m), mod 255 by folding) and
// stages each position's multiply tables (rs_leopard.cuh leo_mul_tables_log:
// E(x_j) at a known position, 1 / E'(x_m) at an erased one; 6 words, the
// last 1 where the position is known) in shared memory, 6 KiB at k = 128,
// beside the transform's and the derivative's tables from the host.
#pragma once

#include <stdint.h>

#include "rs_decode.cuh"  // mod255
#include "rs_leopard.cuh"

namespace ctt {

constexpr uint32_t kLeoDecMaxN = 2u << kLeoMaxLogK;  // positions of an axis, at most
constexpr uint32_t kLeoDecMaxGroups = kLeoDecMaxN - 1 + kLeoMaxLogK + 1;

// The decode's host tables, for n = 2k points: the n - 1 groups of the
// transform (layer j has n >> (j + 1), n - (n >> j) before it), then the
// log2 n derivative constants; 6 words each.
CTT_HD uint32_t leo_dec_groups(uint32_t k) { return 2 * k - 1 + log2_exact(2 * k); }
CTT_HD uint32_t leo_dec_table_bytes(uint32_t k) { return leo_dec_groups(k) * kLeoGroupWords * 4; }
CTT_HD uint32_t leo_dec_group(uint32_t n, uint32_t j, uint32_t g) { return n - (n >> j) + g; }
CTT_HD uint32_t leo_dec_deriv(uint32_t n, uint32_t i) { return n - 1 + i; }

// c_i = W_i'(0) / W_i(v_i): the product of the nonzero elements of the
// span of the first i basis points over the product of v_i ^ v, v in it.
CTT_HD uint32_t leo_deriv_const(uint32_t i, const uint8_t* gexp, const uint8_t* glog) {
  uint32_t num = 1, den = 1;
  for (uint32_t v = 1; v < (1u << i); ++v) num = leo_field_mul(num, v, gexp, glog);
  for (uint32_t v = 0; v < (1u << i); ++v) den = leo_field_mul(den, (1u << i) ^ v, gexp, glog);
  return leo_field_mul(num, gexp[255u - glog[den]], gexp, glog);
}

// The tables of a k-share axis's decode (leo_dec_group / leo_dec_deriv
// order) into out (leo_dec_table_bytes(k) bytes).
CTT_HD void leo_decode_tables(const uint8_t* gexp, const uint8_t* glog, uint32_t k, uint32_t* out) {
  uint8_t skew[8][256];
  leo_skews(gexp, glog, skew);
  const uint32_t n = 2 * k, log_n = log2_exact(n);
  for (uint32_t j = 0; j < log_n; ++j)
    for (uint32_t g = 0; g < (n >> (j + 1)); ++g)
      leo_mul_tables(skew[j][(g << (j + 1)) & 255u], gexp, glog,
                     out + kLeoGroupWords * leo_dec_group(n, j, g));
  for (uint32_t i = 0; i < log_n; ++i)
    leo_mul_tables(leo_deriv_const(i, gexp, glog), gexp, glog,
                   out + kLeoGroupWords * leo_dec_deriv(n, i));
}

// --- the block prologue: which points are erased, the per-position tables

struct LeoDecSmem {
  uint32_t pos[kLeoDecMaxN * kLeoGroupWords];  // point j's tables, word 5 its known flag
  uint32_t tab[kLeoDecMaxGroups * kLeoGroupWords];  // the host tables, in leo_dec_slot order
  uint8_t exp[512];
  uint8_t log[256];                // log[0] read as 0: a point's own factor adds nothing
  uint8_t known[kLeoDecMaxN];      // 1 where position p is one of the k known
  uint8_t erased[kLeoDecMaxN / 2];  // the erased points, in any order
  uint32_t n_erased;
  uint32_t bad;  // the axis index or a known position lies past 2k
};

CTT_HD uint32_t leo_atomic_add(uint32_t* p, uint32_t v) {
#ifdef __CUDA_ARCH__
  return atomicAdd(p, v);
#else
  const uint32_t old = *p;
  *p = old + v;
  return old;
#endif
}

// Where the tables of the transform's group q of layer j sit in shared
// memory for a launch of 2^c threads a column: a layer a thread runs alone
// (j < log2 W) is stored group-major, the g-th group of each of the 2^c
// threads side by side (thread t's g-th group is q = t * G + g, G = W /
// 2^(j+1)), so that the threads' loads fall in distinct banks; the others
// as the host built them.
CTT_HD uint32_t leo_dec_slot(uint32_t n, uint32_t c, uint32_t j, uint32_t q) {
  const uint32_t log_w = log2_exact(n) - c;
  if (j >= log_w) return leo_dec_group(n, j, q);
  const uint32_t G = 1u << (log_w - j - 1);
  return leo_dec_group(n, j, (q % G << c) + q / G);
}

// Point j's multiply tables for 2^c threads a column: thread t's point
// t W + i at slot i 2^c + t, so that the threads' loads fall in distinct
// banks.
CTT_HD uint32_t leo_dec_pos_slot(uint32_t n, uint32_t c, uint32_t j) {
  const uint32_t log_w = log2_exact(n) - c;
  return ((j & ((1u << log_w) - 1u)) << c) + (j >> log_w);
}

// Step 1, thread tid of nt: stage the tables (leo_dec_slot's order for 2^c
// threads a column), clear the flags.
CTT_HD void leo_dec_stage(LeoDecSmem& sh, const uint32_t* tab, const uint8_t* gexp,
                          const uint8_t* glog, uint32_t k, uint32_t c, int32_t axis, uint32_t tid,
                          uint32_t nt) {
  const uint32_t n = 2 * k, transform = n - 1;
  const uint32_t words = leo_dec_groups(k) * kLeoGroupWords;
  for (uint32_t i = tid; i < words; i += nt) {
    uint32_t q = i / kLeoGroupWords, j = 0;
    if (q < transform) {
      while (q >= leo_dec_group(n, j + 1, 0)) ++j;
      q = leo_dec_slot(n, c, j, q - leo_dec_group(n, j, 0));
    }
    sh.tab[q * kLeoGroupWords + i % kLeoGroupWords] = tab[i];
  }
  for (uint32_t i = tid; i < 512; i += nt) sh.exp[i] = gexp[i];
  for (uint32_t i = tid; i < 256; i += nt) {
    sh.log[i] = i ? glog[i] : 0;
    sh.known[i] = 0;
  }
  if (tid == 0) {
    sh.n_erased = 0;
    sh.bad = axis < 0 || static_cast<uint32_t>(axis) >= 2 * k;
  }
}

// Step 2: mark the axis's k known positions (known_a uint8[k]).
CTT_HD void leo_dec_mark(LeoDecSmem& sh, const uint8_t* known_a, uint32_t k, uint32_t tid,
                         uint32_t nt) {
  for (uint32_t i = tid; i < k; i += nt) {
    const uint32_t p = known_a[i];
    if (p < 2 * k)
      sh.known[p] = 1;
    else
      sh.bad = 1;
  }
}

// Step 3: list the erased points.  Unless the positions were distinct,
// more than k are erased: the kernel then leaves the axis as it is.
CTT_HD void leo_dec_list(LeoDecSmem& sh, uint32_t k, uint32_t tid, uint32_t nt) {
  for (uint32_t p = tid; p < 2 * k; p += nt)
    if (!sh.known[p]) {
      const uint32_t slot = leo_atomic_add(&sh.n_erased, 1);
      if (slot < k) sh.erased[slot] = static_cast<uint8_t>(p ^ k);
    }
}

CTT_HD bool leo_dec_skip(const LeoDecSmem& sh, uint32_t k) { return sh.bad || sh.n_erased != k; }

// Step 4: position p's tables: E(x_j) where p is known, 1 / E'(x_j) where
// it is erased (j = p ^ k; both sums have the same form, L[j]), at point
// j's slot for 2^c threads a column.
CTT_HD void leo_dec_scales(LeoDecSmem& sh, uint32_t k, uint32_t c, uint32_t tid, uint32_t nt) {
  for (uint32_t p = tid; p < 2 * k; p += nt) {
    const uint32_t j = p ^ k;
    uint32_t sum = 0;  // at most 128 * 254 < 2^16
    for (uint32_t m = 0; m < k; ++m) sum += sh.log[j ^ sh.erased[m]];
    const uint32_t L = mod255(sum);
    uint32_t* out = sh.pos + kLeoGroupWords * leo_dec_pos_slot(2 * k, c, j);
    leo_mul_tables_log(sh.known[p] ? L : kGfOrder - L, sh.exp, sh.log, out);
    out[kLeoGroupWords - 1] = sh.known[p];
  }
}

// --- a column's T = 2^C threads --------------------------------------------

template <uint32_t LOG_N, uint32_t C>
struct LeoDec {
  static_assert(C >= 1 && C <= LOG_N && C <= 5, "2..32 threads a column, at most n");
  static constexpr uint32_t N = 1u << LOG_N, K = N / 2, T = 1u << C;
  static constexpr uint32_t LOG_W = LOG_N - C, W = 1u << LOG_W;
  static constexpr uint32_t LANES = 32u >> C;  // columns a warp; thread t's lane distance
};

template <uint32_t LOG_N, uint32_t C>
using LeoDecWords = uint32_t[LeoDec<LOG_N, C>::W];

// Thread t's words: the known positions' words times E(x_j), 0 at the
// erased ones (which may hold anything: they are not read).
template <uint32_t LOG_N, uint32_t C>
CTT_HD void leo_dec_load(const uint8_t* col, uint64_t ps, const uint32_t* pos, uint32_t t,
                         LeoDecWords<LOG_N, C>& x) {
  using D = LeoDec<LOG_N, C>;
#pragma unroll
  for (uint32_t i = 0; i < D::W; ++i) {
    const uint32_t p = (t * D::W + i) ^ D::K;
    const uint32_t* tp = pos + kLeoGroupWords * ((i << C) + t);
    uint32_t tt[5];
    leo_load_group_fresh(tp, tt);
    const uint32_t v = tp[kLeoGroupWords - 1] ? ld32(col + p * ps) : 0u;
    x[i] = leo_mul_word(v, tt);
  }
}

// Thread t's erased positions, each word times 1 / E'(x_j).
template <uint32_t LOG_N, uint32_t C>
CTT_HD void leo_dec_store(uint8_t* col, uint64_t ps, const uint32_t* pos, uint32_t t,
                          const LeoDecWords<LOG_N, C>& x) {
  using D = LeoDec<LOG_N, C>;
#pragma unroll
  for (uint32_t i = 0; i < D::W; ++i) {
    const uint32_t p = (t * D::W + i) ^ D::K;
    const uint32_t* tp = pos + kLeoGroupWords * ((i << C) + t);
    uint32_t tt[5];
    leo_load_group_fresh(tp, tt);
    if (!tp[kLeoGroupWords - 1]) st32(col + p * ps, leo_mul_word(x[i], tt));
  }
}

// The layers with dist < W (in a thread): the IFFT's J = 0 .. log2 W - 1,
// the FFT's log2 W - 1 .. 0.
template <uint32_t LOG_N, uint32_t C, uint32_t J = 0>
CTT_HD void leo_dec_ifft_local(LeoDecWords<LOG_N, C>& x, const uint32_t* tab, uint32_t t) {
  using D = LeoDec<LOG_N, C>;
  if constexpr (J < D::LOG_W) {
    leo_part_layer<D::LOG_W, J, false, D::T>(x, tab + kLeoGroupWords * leo_dec_group(D::N, J, 0),
                                             t);
    leo_dec_ifft_local<LOG_N, C, J + 1>(x, tab, t);
  }
}

template <uint32_t LOG_N, uint32_t C, uint32_t J = LeoDec<LOG_N, C>::LOG_W>
CTT_HD void leo_dec_fft_local(LeoDecWords<LOG_N, C>& x, const uint32_t* tab, uint32_t t) {
  using D = LeoDec<LOG_N, C>;
  if constexpr (J > 0) {
    leo_part_layer<D::LOG_W, J - 1, true, D::T>(
        x, tab + kLeoGroupWords * leo_dec_group(D::N, J - 1, 0), t);
    leo_dec_fft_local<LOG_N, C, J - 1>(x, tab, t);
  }
}

// The layers with dist >= W pair thread t with t ^ 2^b (layer log2 W + b;
// a: bit b of t clear, b: set); thread t's group there is t >> (b + 1).
// The top layer's one group (b = C - 1) has skew 0; group 0 of the others
// too, whose tables are zero, so all T threads run one instruction stream.
template <uint32_t LOG_N, uint32_t C>
CTT_HD const uint32_t* leo_dec_cross_group(const uint32_t* tab, uint32_t b, uint32_t t) {
  using D = LeoDec<LOG_N, C>;
  return tab + kLeoGroupWords * leo_dec_group(D::N, D::LOG_W + b, t >> (b + 1));
}

// A cross layer of the IFFT on a word, given the partner's word:
// b' = a ^ b; a' = a ^ s * b'.
CTT_HD uint32_t leo_dec_ifft_cross(uint32_t x, uint32_t peer, const uint32_t tt[5], bool b_side) {
  const uint32_t y = x ^ peer;
  const uint32_t m = leo_mul_word(y, tt);
  return b_side ? y : x ^ m;
}

// A cross layer of the FFT: a' = a ^ s * b; b' = b ^ a'.
CTT_HD uint32_t leo_dec_fft_cross(uint32_t x, uint32_t peer, const uint32_t tt[5], bool b_side) {
  const uint32_t m = leo_mul_word(b_side ? x : peer, tt);
  return x ^ m ^ (b_side ? peer : 0u);
}

// The top layer of either transform (skew 0): b ^= a alone.
CTT_HD uint32_t leo_dec_top(uint32_t x, uint32_t peer, bool b_side) {
  return x ^ (b_side ? peer : 0u);
}

// The derivative's terms of word M from levels I .. log2 W - 1 (in a
// thread): c_I * x[M | 2^I] where bit I of M is clear.
template <uint32_t LOG_N, uint32_t C, uint32_t M, uint32_t I = 0>
CTT_HD uint32_t leo_dec_deriv_local(const LeoDecWords<LOG_N, C>& x, const uint32_t* tab) {
  using D = LeoDec<LOG_N, C>;
  if constexpr (I >= D::LOG_W) {
    return 0u;
  } else {
    const uint32_t rest = leo_dec_deriv_local<LOG_N, C, M, I + 1>(x, tab);
    if constexpr ((M >> I) & 1u) {
      return rest;
    } else {
      uint32_t tt[5];
      leo_load_group_fresh(tab + kLeoGroupWords * leo_dec_deriv(D::N, I), tt);
      return rest ^ leo_mul_word(x[M | (1u << I)], tt);
    }
  }
}

// Thread t's word M of the derivative, from its own words above M and the
// partners' word M before the step (peer[b] from thread t ^ 2^b): level
// log2 W + b adds c * peer[b] where bit b of t is clear.
template <uint32_t LOG_N, uint32_t C, uint32_t M>
CTT_HD uint32_t leo_dec_deriv_word(const LeoDecWords<LOG_N, C>& x, const uint32_t* tab,
                                   const uint32_t (&peer)[C], uint32_t t) {
  using D = LeoDec<LOG_N, C>;
  uint32_t acc = leo_dec_deriv_local<LOG_N, C, M>(x, tab);
#pragma unroll
  for (uint32_t b = 0; b < C; ++b) {
    uint32_t tt[5];
    leo_load_group_fresh(tab + kLeoGroupWords * leo_dec_deriv(D::N, D::LOG_W + b), tt);
    const uint32_t m = leo_mul_word(peer[b], tt);
    acc ^= (t >> b) & 1u ? 0u : m;
  }
  return acc;
}

// k = 1: the polynomial of degree 0 through the known cell is that cell's
// value, so the other position takes it (one thread a column).
CTT_HD void leo_dec_one(uint8_t* col, uint64_t ps, const LeoDecSmem& sh) {
  for (uint32_t p = 0; p < 2; ++p)
    if (!sh.known[p]) st32(col + p * ps, ld32(col + (p ^ 1u) * ps));
}

// The launch's shape by its axis count (chip_smoke.py's probes of 2^2 to
// 2^5 threads a column on an H100).  Many axes share each block's prologue
// and fill the card: 8 warps, 32 or fewer words a thread (4 threads a
// column, 8 at k = 128: with 64 words a thread the registers spill).  A
// few axes -- the deep peel's one- and two-axis phases -- spread each
// column over more threads, so that a phase waits for a smaller share of
// a column's work: 32 threads (one warp a column) for at most 8 axes, 16
// below 66; 4 warps a block.  At most 2k threads a column.
constexpr uint32_t kLeoDecManyAxes = 66;
constexpr uint32_t kLeoDecFewAxes = 8;
constexpr uint32_t kLeoDecMaxLogWords = 5;  // 32 words a thread in the many-axes shape
CTT_HD constexpr uint32_t leo_dec_log_threads(uint32_t n_axes, uint32_t log_n) {
  const uint32_t c = n_axes >= kLeoDecManyAxes
                         ? (log_n > kLeoDecMaxLogWords + 2 ? log_n - kLeoDecMaxLogWords : 2u)
                         : (n_axes > kLeoDecFewAxes ? 4u : 5u);
  return c < log_n ? c : log_n;
}
CTT_HD uint32_t leo_dec_warps(uint32_t n_axes) { return n_axes >= kLeoDecManyAxes ? 8u : 4u; }

}  // namespace ctt
