// CPU twin of the CUDA kernels: the same per-thread bodies (sha256.cuh,
// nmt.cuh, rs_extend.cuh, rs_leopard.cuh, rs_leopard_decode.cuh,
// rs_decode.cuh, rs_sharded.cuh, das_gather.cuh),
// compiled by g++ and looped over the thread indices on the host; for the
// block-cooperative NMT kernels (nmt.cuh) block by block, each step over
// every thread between the barriers; for the tensor-core bit-GEMM
// (rs_extend.cuh) over blocks, warps and lanes, with a host emulation of
// mma.sync in the PTX fragment layouts.  It lets the tests hold the kernels' arithmetic
// against the JAX package on a machine without a card; it is never on the
// port's path.  Build: g++ -O2 -std=c++17 -shared -fPIC cpu_twin.cpp.
#include <string.h>

#include <algorithm>
#include <vector>

#include "das_gather.cuh"
#include "nmt.cuh"
#include "rs_decode.cuh"
#include "rs_extend.cuh"
#include "rs_leopard.cuh"
#include "rs_leopard_decode.cuh"
#include "rs_sharded.cuh"

namespace {

// One block of the GF(2) bit-GEMM (rs_extend.cuh gf2_gemm) over n_tiles
// tiles of `ax`, n_in inputs each: its groups' expansion items, each from
// its coefficient C(o, j) (zero for o >= n_out or j >= n_in) and the
// product table, then tiles, chunks, the 8 warps and their 32 lanes in
// order.  Each k-step builds every lane's fragments with the kernel's own
// functions, then the host emulation of mma.sync runs each (m-tile, n-tile)
// product over the warp.
template <class Axes, class Coef>
void twin_gf2_gemm(const Axes& ax, uint32_t n_tiles, uint32_t n_in, uint32_t n_out, const Coef& C,
                   const uint8_t* prod) {
  using namespace ctt;
  const uint32_t n_chunks = gf2_chunks(n_in), items = n_chunks * 128u;
  uint32_t groups = 0;
  for (uint32_t tile = 0; tile < n_tiles; ++tile) groups = std::max(groups, ax.group(tile) + 1);
  std::vector<uint8_t> frags(size_t(groups) * gf2_frag_bytes(n_in));
  for (uint32_t i = 0; i < groups * items; ++i) {
    uint32_t o, j;
    gf2_item_coef(i % items, &o, &j);
    o += i / items * kGf2Outputs;
    gf2_expand_item(o < n_out && j < n_in ? C(o, j) : 0u, prod,
                    frags.data() + (i / items) * gf2_frag_bytes(n_in), i % items);
  }
  std::vector<int32_t> acc_v(size_t(kGf2Warps) * 32 * kGf2Mt * kGf2Nt * 4);
  auto acc = reinterpret_cast<int32_t(*)[32][kGf2Mt][kGf2Nt][4]>(acc_v.data());
  for (uint32_t tile = 0; tile < n_tiles; ++tile) {
    const uint8_t* fg = frags.data() + size_t(ax.group(tile)) * gf2_frag_bytes(n_in);
    std::fill(acc_v.begin(), acc_v.end(), 0);
    for (uint32_t c = 0; c < n_chunks; ++c) {
      for (uint32_t warp = 0; warp < kGf2Warps; ++warp) {
        uint32_t x[32][4][2];
        for (uint32_t lane = 0; lane < 32; ++lane) gf2_lane_chunk(ax, tile, n_in, c, warp, lane, x[lane]);
        for (uint32_t kk = 0; kk < 4; ++kk) {
          uint32_t af[32][kGf2Mt][4], bf[32][kGf2Nt][2];
          for (uint32_t lane = 0; lane < 32; ++lane) {
            for (uint32_t mt = 0; mt < kGf2Mt; ++mt) gf2_lane_afrag(fg, c, kk, mt, lane, af[lane][mt]);
            gf2_b_frags(x[lane][kk], bf[lane]);
          }
          for (uint32_t mt = 0; mt < kGf2Mt; ++mt)
            for (uint32_t nt = 0; nt < kGf2Nt; ++nt) {
              int32_t d[32][4];
              uint32_t av[32][4], bv[32][2];
              for (uint32_t lane = 0; lane < 32; ++lane) {
                memcpy(d[lane], acc[warp][lane][mt][nt], sizeof d[lane]);
                memcpy(av[lane], af[lane][mt], sizeof av[lane]);
                memcpy(bv[lane], bf[lane][nt], sizeof bv[lane]);
              }
              gf2_mma_warp(d, av, bv);
              for (uint32_t lane = 0; lane < 32; ++lane)
                memcpy(acc[warp][lane][mt][nt], d[lane], sizeof d[lane]);
            }
        }
      }
    }
    for (uint32_t warp = 0; warp < kGf2Warps; ++warp)
      for (uint32_t lane = 0; lane < 32; ++lane) {
        const uint32_t g = lane / 4, q = lane % 4;
        if (g >= ax.outputs(tile)) continue;
        uint32_t v[4];
        gf2_pack(acc[warp][lane], v);
        memcpy(ax.dst(tile, g) + warp * kGf2WarpBytes + 16 * q, v, 16);
      }
  }
}

std::vector<uint8_t> twin_products(const uint8_t* gexp, const uint8_t* glog) {
  std::vector<uint8_t> prod(256 * 8);
  for (uint32_t c = 0; c < 256; ++c) ctt::gf2_product_row(c, gexp, glog, prod.data() + 8 * c);
  return prod;
}

// The blocks of one rs_gf2_encode_kernel launch (rs_extend.cu
// launch_encode): k outputs of n_axes axes of each of nz (square, set)
// pairs, set = z % nsets of s[0..nsets), square z / nsets at ibs / obs bytes
// on.  s[] holds (in, out, as, ps, oas, ops) as AxisSet does.
struct TwinAxisSet {
  const uint8_t* in;
  uint8_t* out;
  uint64_t as, ps, oas, ops;
};

void twin_encode(const TwinAxisSet* s, const uint8_t* E, const uint8_t* gexp, const uint8_t* glog,
                 uint32_t k, uint32_t n_in, uint32_t n_axes, uint32_t nsets, uint32_t nz,
                 uint64_t ibs, uint64_t obs) {
  using namespace ctt;
  const std::vector<uint8_t> prod = twin_products(gexp, glog);
  const uint32_t groups = (k + kGf2Outputs - 1) / kGf2Outputs;
  const uint32_t apb = gf2_axes_per_block(groups * nz, n_axes);
  for (uint32_t z = 0; z < nz; ++z)
    for (uint32_t y = 0; y < (n_axes + apb - 1) / apb; ++y)
      for (uint32_t x = 0; x < groups; ++x) {
        const TwinAxisSet& st = s[z % nsets];
        const uint64_t b = z / nsets;
        const uint32_t i0 = x * kGf2Outputs, a0 = y * apb;
        const uint32_t nout = k - i0 < kGf2Outputs ? k - i0 : kGf2Outputs;
        const uint32_t na = n_axes - a0 < apb ? n_axes - a0 : apb;
        const Gf2EncodeAxes ax{st.in + b * ibs + a0 * st.as,
                               st.out + b * obs + a0 * st.oas + i0 * st.ops, st.as, st.ps,
                               st.oas, st.ops, nout};
        twin_gf2_gemm(ax, na, n_in, nout,
                      [&](uint32_t o, uint32_t j) { return E[(i0 + o) * n_in + j]; }, prod.data());
      }
}

// The threads of one rs_leopard_kernel launch (rs_leopard.cu
// launch_encode): every word column of n_axes axes of each of nz (square,
// set) pairs, set = z % nsets of s[0..nsets), square z / nsets at ibs / obs
// bytes on, each column's two halves (lanes l and l + 16) step by step:
// both halves' IFFT layers, the cross step with the other half's words
// (the kernel's shuffle), both halves' FFT layers.
template <uint32_t LOG_K>
void twin_leo_axes(const ctt::LeoAxisSet* s, const uint32_t* tab, uint32_t n_axes, uint32_t nsets,
                   uint32_t nz, uint64_t ibs, uint64_t obs) {
  constexpr uint32_t K = 1u << LOG_K;
  for (uint32_t z = 0; z < nz; ++z)
    for (uint32_t a = 0; a < n_axes; ++a)
      for (uint32_t w = 0; w < ctt::kLeoWords; ++w) {
        const ctt::LeoAxisSet& st = s[z % nsets];
        const uint64_t b = z / nsets;
        const uint8_t* in = st.in + b * ibs + a * st.as + 4 * w;
        uint8_t* out = st.out + b * obs + a * st.oas + 4 * w;
        if constexpr (LOG_K == 0) {
          memcpy(out, in, 4);
        } else {
          uint32_t x[2][K / 2], t[5];
          for (uint32_t h = 0; h < 2; ++h) {
            ctt::leo_half_load<LOG_K>(in, st.ps, h, x[h]);
            ctt::leo_half_ifft<LOG_K>(x[h], tab, h);
          }
          ctt::leo_load_group(ctt::leo_cross_group(tab, K), t);
          for (uint32_t i = 0; i < K / 2; ++i) {
            const uint32_t a0 = x[0][i], a1 = x[1][i];
            x[0][i] = ctt::leo_cross_word(a0, a1, t);
            x[1][i] = ctt::leo_cross_word(a1, a0, t);
          }
          for (uint32_t h = 0; h < 2; ++h) {
            ctt::leo_half_fft<LOG_K>(x[h], tab, h);
            ctt::leo_half_store<LOG_K>(out, st.ops, h, x[h]);
          }
        }
      }
}

void twin_leo_encode(const ctt::LeoAxisSet* s, const uint32_t* tab, int k, uint32_t n_axes,
                     uint32_t nsets, uint32_t nz, uint64_t ibs, uint64_t obs) {
  switch (ctt::log2_exact(uint64_t(k))) {
    case 0: return twin_leo_axes<0>(s, tab, n_axes, nsets, nz, ibs, obs);
    case 1: return twin_leo_axes<1>(s, tab, n_axes, nsets, nz, ibs, obs);
    case 2: return twin_leo_axes<2>(s, tab, n_axes, nsets, nz, ibs, obs);
    case 3: return twin_leo_axes<3>(s, tab, n_axes, nsets, nz, ibs, obs);
    case 4: return twin_leo_axes<4>(s, tab, n_axes, nsets, nz, ibs, obs);
    case 5: return twin_leo_axes<5>(s, tab, n_axes, nsets, nz, ibs, obs);
    case 6: return twin_leo_axes<6>(s, tab, n_axes, nsets, nz, ibs, obs);
    case 7: return twin_leo_axes<7>(s, tab, n_axes, nsets, nz, ibs, obs);
    default: return;
  }
}

// K5's FFT over half h given its tables, out of line: the partial's
// instances of one k share it.
template <uint32_t LOG_K>
__attribute__((noinline)) void twin_leo_half_fft_at(uint32_t (&x)[1u << (LOG_K - 1)],
                                                    const uint32_t* fft, uint32_t h) {
  ctt::leo_half_fft_at<LOG_K>(x, fft, h);
}

template <uint32_t LOG_K, uint32_t LOG_M>
__attribute__((noinline)) void twin_leo_partial_ifft(const uint8_t* p, uint64_t stride,
                                                     const uint32_t* tab, uint32_t j0, uint32_t h,
                                                     uint32_t (&x)[1u << (LOG_K - 1)]) {
  ctt::leo_partial_ifft<LOG_K, LOG_M>(p, stride, tab, j0, h, x);
}

// The blocks of one rs_leopard_partial_kernel launch one after another,
// each word column's two threads in turn (at m = k K5's encode, its cross
// step over both halves as twin_leo_axes takes it).
template <uint32_t LOG_K, uint32_t LOG_M>
void twin_leo_partial(const uint8_t* top, uint8_t* partial, const uint32_t* tab, uint32_t j0,
                      uint32_t n) {
  constexpr uint32_t K = 1u << LOG_K, M = 1u << LOG_M;
  const uint64_t row = 2ull * K * ctt::kLeoShare;
  for (uint32_t b = 0; b < n; ++b)
    for (uint32_t c = 0; c < 2 * K; ++c)
      for (uint32_t w = 0; w < ctt::kLeoWords; ++w) {
        const uint8_t* in = top + b * M * row + c * ctt::kLeoShare + 4 * w;
        uint8_t* out = partial + b * K * row + c * ctt::kLeoShare + 4 * w;
        if constexpr (LOG_K == 0) {
          memcpy(out, in, 4);
        } else {
          uint32_t x[2][K / 2];
          if constexpr (LOG_M == LOG_K) {
            uint32_t t[5];
            for (uint32_t h = 0; h < 2; ++h) {
              ctt::leo_half_load<LOG_K>(in, row, h, x[h]);
              ctt::leo_half_ifft<LOG_K>(x[h], tab, h);
            }
            ctt::leo_load_group(ctt::leo_cross_group(tab, K), t);
            for (uint32_t i = 0; i < K / 2; ++i) {
              const uint32_t a0 = x[0][i], a1 = x[1][i];
              x[0][i] = ctt::leo_cross_word(a0, a1, t);
              x[1][i] = ctt::leo_cross_word(a1, a0, t);
            }
          } else {
            for (uint32_t h = 0; h < 2; ++h)
              twin_leo_partial_ifft<LOG_K, LOG_M>(in, row, tab, j0, h, x[h]);
          }
          for (uint32_t h = 0; h < 2; ++h) {
            twin_leo_half_fft_at<LOG_K>(
                x[h], tab + ctt::kLeoGroupWords * ctt::leo_partial_fft_group(K, M), h);
            ctt::leo_half_store<LOG_K>(out, row, h, x[h]);
          }
        }
      }
}

template <uint32_t LOG_K, uint32_t LOG_M = 0>
void twin_leo_partial_m(uint32_t log_m, const uint8_t* top, uint8_t* partial, const uint32_t* tab,
                        uint32_t j0, uint32_t n) {
  if constexpr (LOG_M <= LOG_K) {
    if (log_m == LOG_M) return twin_leo_partial<LOG_K, LOG_M>(top, partial, tab, j0, n);
    twin_leo_partial_m<LOG_K, LOG_M + 1>(log_m, top, partial, tab, j0, n);
  }
}

// The derivative of rs_leopard_decode_kernel over a column's 2^C threads
// in lockstep: at each word M every thread's partners' word M is taken
// before any thread overwrites its own (the kernel's shuffles).
template <uint32_t LOG_N, uint32_t C, uint32_t M = 0>
void twin_leo_dec_deriv(uint32_t (&x)[1u << C][ctt::LeoDec<LOG_N, C>::W], const uint32_t* tab) {
  if constexpr (M < ctt::LeoDec<LOG_N, C>::W) {
    constexpr uint32_t T = 1u << C;
    uint32_t v[T];
    for (uint32_t t = 0; t < T; ++t) v[t] = x[t][M];
    for (uint32_t t = 0; t < T; ++t) {
      uint32_t peer[C];
      for (uint32_t b = 0; b < C; ++b) peer[b] = v[t ^ (1u << b)];
      x[t][M] = ctt::leo_dec_deriv_word<LOG_N, C, M>(x[t], tab, peer, t);
    }
    twin_leo_dec_deriv<LOG_N, C, M + 1>(x, tab);
  }
}

// One word column of rs_leopard_decode_kernel: its 2^C threads step by
// step, each exchange (a shuffle in the kernel) reading the partners'
// words from before the step.
template <uint32_t LOG_N, uint32_t C>
void twin_leo_dec_column(uint8_t* col, uint64_t ps, const ctt::LeoDecSmem& sh) {
  using D = ctt::LeoDec<LOG_N, C>;
  uint32_t x[D::T][D::W];
  // layer log2 W + b of the IFFT (fft false) or the FFT over all threads
  auto cross = [&](uint32_t b, bool fft) {
    uint32_t y[D::T][D::W];
    memcpy(y, x, sizeof y);
    for (uint32_t t = 0; t < D::T; ++t) {
      const bool b_side = (t >> b) & 1u;
      uint32_t tt[5];
      if (b + 1 < C) ctt::leo_load_group_fresh(ctt::leo_dec_cross_group<LOG_N, C>(sh.tab, b, t), tt);
      for (uint32_t i = 0; i < D::W; ++i) {
        const uint32_t peer = y[t ^ (1u << b)][i];
        x[t][i] = b + 1 == C ? ctt::leo_dec_top(y[t][i], peer, b_side)
                  : fft      ? ctt::leo_dec_fft_cross(y[t][i], peer, tt, b_side)
                             : ctt::leo_dec_ifft_cross(y[t][i], peer, tt, b_side);
      }
    }
  };
  for (uint32_t t = 0; t < D::T; ++t) {
    ctt::leo_dec_load<LOG_N, C>(col, ps, sh.pos, t, x[t]);
    ctt::leo_dec_ifft_local<LOG_N, C>(x[t], sh.tab, t);
  }
  for (uint32_t b = 0; b < C; ++b) cross(b, false);
  twin_leo_dec_deriv<LOG_N, C>(x, sh.tab);
  for (uint32_t b = C; b-- > 0;) cross(b, true);
  for (uint32_t t = 0; t < D::T; ++t) {
    ctt::leo_dec_fft_local<LOG_N, C>(x[t], sh.tab, t);
    ctt::leo_dec_store<LOG_N, C>(col, ps, sh.pos, t, x[t]);
  }
}

// The blocks of one rs_leopard_decode_kernel launch one after another:
// each block's prologue step by step over its threads, then its columns.
template <uint32_t LOG_N, uint32_t C>
void twin_leo_decode_n(uint8_t* eds, const uint8_t* known, const int32_t* axes,
                       const uint32_t* tab, const uint8_t* gexp, const uint8_t* glog, uint32_t n,
                       uint64_t as, uint64_t ps) {
  constexpr uint32_t K = (1u << LOG_N) / 2;
  const uint32_t nt = ctt::leo_dec_warps(n) * 32, columns = nt >> C;
  std::vector<ctt::LeoDecSmem> smem(1);
  ctt::LeoDecSmem& sh = smem[0];
  for (uint32_t a = 0; a < n; ++a)
    for (uint32_t bx = 0; bx < ctt::kLeoWords / columns; ++bx) {
      for (uint32_t tid = 0; tid < nt; ++tid)
        ctt::leo_dec_stage(sh, tab, gexp, glog, K, C, axes[a], tid, nt);
      for (uint32_t tid = 0; tid < nt; ++tid)
        ctt::leo_dec_mark(sh, known + size_t(a) * K, K, tid, nt);
      for (uint32_t tid = 0; tid < nt; ++tid) ctt::leo_dec_list(sh, K, tid, nt);
      if (ctt::leo_dec_skip(sh, K)) continue;
      for (uint32_t tid = 0; tid < nt; ++tid) ctt::leo_dec_scales(sh, K, C, tid, nt);
      for (uint32_t c = 0; c < columns; ++c) {
        uint8_t* col = eds + uint32_t(axes[a]) * as + 4ull * (bx * columns + c);
        if constexpr (LOG_N == 1)
          ctt::leo_dec_one(col, ps, sh);
        else
          twin_leo_dec_column<LOG_N, C>(col, ps, sh);
      }
    }
}

// 2^C threads a column as the kernel's launch picks them.
template <uint32_t LOG_N>
void twin_leo_decode_k(uint8_t* eds, const uint8_t* known, const int32_t* axes,
                       const uint32_t* tab, const uint8_t* gexp, const uint8_t* glog, uint32_t n,
                       uint64_t as, uint64_t ps) {
  constexpr uint32_t many = ctt::leo_dec_log_threads(ctt::kLeoDecManyAxes, LOG_N);
  constexpr uint32_t some = ctt::leo_dec_log_threads(ctt::kLeoDecFewAxes + 1, LOG_N);
  constexpr uint32_t few = ctt::leo_dec_log_threads(1, LOG_N);
  const uint32_t c = ctt::leo_dec_log_threads(n, LOG_N);
  if (c == many)
    twin_leo_decode_n<LOG_N, many>(eds, known, axes, tab, gexp, glog, n, as, ps);
  else if (c == some)
    twin_leo_decode_n<LOG_N, some>(eds, known, axes, tab, gexp, glog, n, as, ps);
  else
    twin_leo_decode_n<LOG_N, few>(eds, known, axes, tab, gexp, glog, n, as, ps);
}

}  // namespace

extern "C" {

void twin_sha256_batch(const uint8_t* msgs, uint8_t* out, long long n, int L, int prefix) {
  const uint32_t skip = prefix >= 0 ? 1u : 0u;
  for (long long i = 0; i < n; ++i) {
    uint32_t st[8];
    ctt::sha256_message(ctt::PrefixedSrc{msgs + i * L, skip, uint32_t(prefix >= 0 ? prefix : 0)},
                        uint32_t(L) + skip, st);
    ctt::store_digest(st, out + i * 32);
  }
}

// K2 over a window of n_rows EDS rows from row0 (of each of batch EDSs), as
// ctt_nmt_leaf_digests launches it: the blocks of 64 cells one after
// another, each step of nmt_leaf_kernel run for every thread before the
// next (the barriers).  Returns 0, or 1 where the C entry refuses.
int twin_nmt_leaf_digests_window(const uint8_t* eds, uint8_t* out, int n2, int batch, int row0,
                                 int n_rows) {
  using namespace ctt;
  const uint32_t lg_n2 = log2_exact(uint64_t(n2 > 0 ? n2 : 0));
  const uint64_t cells = uint64_t(batch) * uint64_t(n_rows) * uint64_t(n2);
  if (lg_n2 < 1 || lg_n2 > 15 || n_rows < 1 || batch < 1 || cells > 0xFFFFFFFFull ||
      (reinterpret_cast<uintptr_t>(eds) & 15u) || (reinterpret_cast<uintptr_t>(out) & 1u))
    return 1;
  std::vector<uint8_t> rows(kLeafSmemBytes);
  std::vector<LeafHash> h(kLeafCells);
  for (uint64_t cell0 = 0; cell0 < cells; cell0 += kLeafCells) {
    const uint32_t n = uint32_t(std::min<uint64_t>(kLeafCells, cells - cell0));
    for (uint32_t t = 0; t < kLeafCells; ++t)
      nmt_leaf_stage(eds, cell0, n, rows.data(), t, kLeafCells);
    for (uint32_t t = 0; t < n; ++t)
      nmt_leaf_hash(rows.data() + t * kLeafRow,
                    nmt_leaf_q0(uint32_t(cell0) + t, lg_n2, uint32_t(row0), uint32_t(n_rows)), &h[t]);
    for (uint32_t t = 0; t < n; ++t) nmt_leaf_digest(h[t], rows.data() + t * kDigest);
    for (uint32_t t = 0; t < kLeafCells; ++t)
      nmt_leaf_store(out, cell0, n, rows.data(), t, kLeafCells);
  }
  return 0;
}

// K2's row-set mode as ctt_nmt_leaf_digests_rows launches it: the blocks of
// 64 cells one after another, each step of nmt_leaf_rows_kernel run for
// every thread before the next.  Returns 0, or 1 where the C entry refuses.
int twin_nmt_leaf_digests_rows(const uint8_t* src, uint8_t* out, int n2, int n_trees,
                               const uint16_t* ids, int in_place) {
  using namespace ctt;
  NmtRowSet a{};
  if (n2 < 1 || n_trees < 1 ||
      !nmt_rows_setup(&a, src, out, uint32_t(n2), uint32_t(n_trees), ids, uint32_t(in_place)))
    return 1;
  std::vector<uint8_t> rows(kLeafSmemBytes);
  std::vector<LeafHash> h(kLeafCells);
  for (uint32_t cell0 = 0; cell0 < a.cells; cell0 += kLeafCells) {
    const uint32_t n = std::min(kLeafCells, a.cells - cell0);
    for (uint32_t t = 0; t < kLeafCells; ++t) nmt_rows_stage(a, cell0, n, rows.data(), t, kLeafCells);
    for (uint32_t t = 0; t < n; ++t)
      nmt_leaf_hash(rows.data() + t * kLeafRow, nmt_rows_q0(a, cell0 + t), &h[t]);
    for (uint32_t t = 0; t < n; ++t) nmt_leaf_digest(h[t], rows.data() + t * kDigest);
    for (uint32_t t = 0; t < kLeafCells; ++t)
      nmt_leaf_store(a.out, cell0, n, rows.data(), t, kLeafCells);
  }
  return 0;
}

int twin_nmt_leaf_digests_batched(const uint8_t* eds, uint8_t* out, int n2, int batch) {
  return twin_nmt_leaf_digests_window(eds, out, n2, batch, 0, n2);
}

int twin_nmt_leaf_digests(const uint8_t* eds, uint8_t* out, int n2) {
  return twin_nmt_leaf_digests_batched(eds, out, n2, 1);
}

// The SM count K3's tile is chosen for (the H100's 132 unless a test sets
// another).
static uint32_t twin_sms = 132;

void twin_nmt_set_sm_count(int sms) { twin_sms = sms > 0 ? uint32_t(sms) : 132u; }

// K3 as ctt_nmt_reduce_levels launches it on a card of twin_sms SMs: every
// block (x, then the group y) one after another, each step of
// nmt_reduce_kernel run for its 128, 256 or 512 threads before the next
// (the levels warp 0 runs alone over its 32 lanes, the other warps' write
// of the level before them after those).  Returns 0, or 1 where the C
// entry refuses.
int twin_nmt_reduce_levels(const uint8_t* in, uint8_t* out, long long ntrees, int m,
                           int n_levels, long long split, long long ts0, long long ns0,
                           long long ts1, long long ns1, long long tpb, long long bs) {
  using namespace ctt;
  NmtReduceArgs a{};
  const uint32_t per_group = nmt_reduce_setup(&a, in, out, uint64_t(ntrees), uint32_t(m),
                                              uint32_t(n_levels), uint64_t(split), uint64_t(ts0),
                                              uint64_t(ns0), uint64_t(ts1), uint64_t(ns1),
                                              uint64_t(tpb), uint64_t(bs), twin_sms);
  const uint64_t groups = per_group ? uint64_t(ntrees / tpb) : 0;
  if (per_group == 0 || groups > 65535) return 1;
  std::vector<Word16> smem((a.smem + 15) / 16);  // 16-byte aligned, as the kernel's
  const NmtPlanes p = nmt_planes(smem.data(), a.lg_tile);
  const uint32_t nt = 1u << (a.lg_tile - 1);  // the block's threads
  const auto each = [](uint32_t n, auto step) {
    for (uint32_t tid = 0; tid < n; ++tid) step(tid);
  };
  for (uint32_t g = 0; g < groups; ++g)
    for (uint32_t bx = 0; bx < per_group; ++bx) {
      const NmtTile t = nmt_tile(a, bx, g);
      each(nt, [&](uint32_t tid) { nmt_stage(t, p.stage(), tid, nt); });
      each(nt, [&](uint32_t tid) { nmt_unpack(a, t, p, tid, nt); });
      const uint32_t tail = nmt_tail(a, t);
      for (uint32_t j = 1; j <= a.n_levels; ++j) {
        const uint32_t step = j < tail ? nt : 32u;  // the block, or one warp's lanes
        each(step, [&](uint32_t tid) { nmt_level_step(a, t, p, j, tid, step, j < tail); });
      }
      if (tail > a.n_levels) {
        each(nt, [&](uint32_t tid) { nmt_store_level(a, t, p, a.n_levels, tid, nt); });
        continue;
      }
      if (tail > 1)
        each(nt - 32, [&](uint32_t tid) { nmt_store_level(a, t, p, tail - 1, tid, nt - 32); });
      for (uint32_t j = tail; j <= a.n_levels; ++j)
        each(nt, [&](uint32_t tid) { nmt_store_level(a, t, p, j, tid, nt); });
    }
  return 0;
}

// One level (K3 with n_levels = 1): out uint8[ntrees, m_out, 90].
int twin_nmt_combine_level_batched(const uint8_t* in, uint8_t* out, long long ntrees, int m_out,
                                   long long split, long long ts0, long long ns0, long long ts1,
                                   long long ns1, long long tpb, long long bs) {
  return twin_nmt_reduce_levels(in, out, ntrees, 2 * m_out, 1, split, ts0, ns0, ts1, ns1, tpb, bs);
}

int twin_nmt_combine_level(const uint8_t* in, uint8_t* out, long long ntrees, int m_out,
                           long long split, long long ts0, long long ns0, long long ts1,
                           long long ns1) {
  return twin_nmt_combine_level_batched(in, out, ntrees, m_out, split, ts0, ns0, ts1, ns1, ntrees,
                                        0);
}

// K4 as ctt_rfc6962_root launches it: every block (tree) one after
// another, each step of rfc6962_tree_kernel run for all its threads before
// the next (the barriers), the last levels over warp 0's 32 lanes (the
// __syncwarp steps).  levels: uint8[batch, 2n - 1, 32] (leaf hashes first,
// root last).  Returns 0, or 1 where the C entry refuses.
int twin_rfc6962_levels(const uint8_t* in, uint8_t* levels, int batch, int n, int L,
                        int leaf_pass) {
  using namespace ctt;
  RfcArgs a{};
  const uint32_t nt = rfc6962_setup(&a, in, levels, uint64_t(batch > 0 ? batch : 0),
                                    uint32_t(n > 0 ? n : 0), uint32_t(L > 0 ? L : 0),
                                    uint32_t(leaf_pass));
  if (nt == 0) return 1;
  std::vector<uint8_t> smem(a.smem);
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem.data());
  uint8_t* stage = smem.data() + a.stage_off;
  for (uint64_t b = 0; b < uint64_t(batch); ++b) {
    for (uint32_t t0 = 0; t0 < a.n; t0 += a.tile) {
      const RfcTile t = rfc6962_tile(a, b, t0);
      for (uint32_t tid = 0; tid < nt; ++tid) rfc6962_stage(t, stage, tid, nt);
      for (uint32_t tid = 0; tid < nt; ++tid) rfc6962_leaf(a, t, stage, planes, tid);
    }
    uint8_t* tree = levels + b * (2 * a.n - 1) * 32;
    for (uint32_t m = a.n; m >= 1; m >>= 1) {
      const uint32_t step = m > kRfcWarpNodes ? nt : 32u;
      for (uint32_t tid = 0; tid < step; ++tid) rfc6962_level_step(a, planes, tree, m, tid, step);
    }
  }
  return 0;
}

// The root alone: the last row of each tree's levels.
int twin_rfc6962_root(const uint8_t* in, uint8_t* out, int batch, int n, int L, int leaf_pass) {
  if (batch < 1 || n < 1) return 1;
  const size_t rows = 2 * size_t(n) - 1;
  std::vector<uint8_t> levels(size_t(batch) * rows * 32 + 16);
  // a 16-byte aligned output, as the wrappers allocate it
  uint8_t* base = levels.data() + ((16 - reinterpret_cast<uintptr_t>(levels.data()) % 16) % 16);
  if (twin_rfc6962_levels(in, base, batch, n, L, leaf_pass)) return 1;
  for (int b = 0; b < batch; ++b) memcpy(out + size_t(b) * 32, base + (size_t(b) * rows + rows - 1) * 32, 32);
  return 0;
}

std::vector<ctt::GatherSrc> twin_sources(const long long* srcs, int n_srcs) {
  std::vector<ctt::GatherSrc> table(static_cast<size_t>(n_srcs));
  for (int i = 0; i < n_srcs; ++i)
    table[i] = ctt::GatherSrc{reinterpret_cast<const uint8_t*>(uintptr_t(srcs[4 * i])),
                              uint64_t(srcs[4 * i + 1]), uint32_t(srcs[4 * i + 2]),
                              uint32_t(srcs[4 * i + 3])};
  return table;
}

// srcs: n_srcs x 4 int64 (base pointer, row stride, item stride, width), as
// ctt_das_proof_gather takes them; the 32 lanes of each item's warp.
int twin_das_proof_gather(const long long* srcs, int n_srcs, const int32_t* items, int n_items,
                          uint8_t* out) {
  if (n_srcs < 1 || n_srcs > int(ctt::kMaxGatherSrcs) || n_items < 1 ||
      (reinterpret_cast<uintptr_t>(out) & 15u))
    return 1;
  const std::vector<ctt::GatherSrc> table = twin_sources(srcs, n_srcs);
  for (int i = 0; i < n_items; ++i)
    for (uint32_t lane = 0; lane < 32; ++lane)
      ctt::das_gather_body(table.data(), items, out, uint32_t(i), lane, 32);
  return 0;
}

// The cell mode, as ctt_das_cell_gather launches it: the threads of each
// cell (ctt::cell_lanes).  Returns 0, or 1 where the C entry refuses.
int twin_das_cell_gather(const long long* srcs, int n_srcs, int n_sib, int sib0, int n_aunt,
                         int aunt0, int share, const int32_t* cells, int n_cells, uint8_t* out) {
  if (n_srcs < 1 || n_srcs > int(ctt::kMaxGatherSrcs) || n_cells < 1 || n_sib < 1 || n_sib > 16 ||
      n_aunt < 1 || n_aunt > 17 || sib0 < 0 || sib0 + n_sib > n_srcs || aunt0 < 0 ||
      aunt0 + n_aunt > n_srcs || share < 0 || share >= n_srcs ||
      (reinterpret_cast<uintptr_t>(out) & 15u))
    return 1;
  const std::vector<ctt::GatherSrc> table = twin_sources(srcs, n_srcs);
  const ctt::CellArgs a = ctt::cell_args(n_sib, sib0, n_aunt, aunt0, share);
  const uint32_t lanes = ctt::cell_lanes(a);
  for (int c = 0; c < n_cells; ++c) {
    const int32_t* t = cells + 3 * c;
    for (uint32_t lane = 0; lane < lanes; ++lane)
      ctt::das_cell_word(a, table.data(), uint32_t(t[0]), uint32_t(t[1]), uint32_t(t[2]),
                         out + size_t(c) * 16 * a.words, lane);
  }
  return 0;
}

// The (level, node) of each of column c's n_sib siblings as the cell mode
// derives them: int32[n_sib, 2].
void twin_das_cell_siblings(int c, int n_sib, int32_t* out) {
  for (int j = 0; j < n_sib; ++j) {
    const uint32_t l = ctt::cell_sibling_level(uint32_t(c), uint32_t(n_sib), uint32_t(j));
    out[2 * j] = int32_t(l);
    out[2 * j + 1] = int32_t((uint32_t(c) >> l) ^ 1u);
  }
}

// squares uint8[n, k, k, 512] -> eds uint8[n, 2k, 2k, 512] in the order of
// ctt_rs_extend_batched's launches: every square's Q0 copy, then Q1 and Q2
// of each square (blockIdx.z = 2b + set), then Q3 of each.
void twin_rs_extend_batched(const uint8_t* squares, uint8_t* eds, const uint8_t* E,
                            const uint8_t* gexp, const uint8_t* glog, int k, int n) {
  const uint64_t S = 512, K = uint64_t(k), sq_bytes = K * K * S, eds_bytes = 4 * K * K * S;
  for (int b = 0; b < n; ++b)
    for (uint64_t r = 0; r < K; ++r)
      memcpy(eds + b * eds_bytes + r * 2 * K * S, squares + b * sq_bytes + r * K * S, K * S);
  uint8_t* q1 = eds + K * S;
  uint8_t* q2 = eds + K * 2 * K * S;
  const TwinAxisSet sets[2] = {{squares, q1, K * S, S, 2 * K * S, S},
                               {squares, q2, S, K * S, S, 2 * K * S}};
  twin_encode(sets, E, gexp, glog, k, k, k, 2, 2 * n, sq_bytes, eds_bytes);
  const TwinAxisSet q1cols{q1, q2 + K * S, S, 2 * K * S, S, 2 * K * S};  // -> Q3
  twin_encode(&q1cols, E, gexp, glog, k, k, k, 1, n, eds_bytes, eds_bytes);
}

void twin_rs_extend(const uint8_t* square, uint8_t* eds, const uint8_t* E, const uint8_t* gexp,
                    const uint8_t* glog, int k) {
  twin_rs_extend_batched(square, eds, E, gexp, glog, k, 1);
}

// rows uint8[n, k, 512] -> out uint8[n, 2k, 512], as ctt_rs_extend_rows.
void twin_rs_extend_rows(const uint8_t* rows, uint8_t* out, const uint8_t* E, const uint8_t* gexp,
                         const uint8_t* glog, int k, int n) {
  const uint64_t S = 512, K = uint64_t(k);
  for (int r = 0; r < n; ++r) memcpy(out + r * 2 * K * S, rows + r * K * S, K * S);
  const TwinAxisSet set{rows, out + K * S, K * S, S, 2 * K * S, S};
  twin_encode(&set, E, gexp, glog, k, k, uint32_t(n), 1, 1, 0, 0);
}

// K9a, as ctt_rs_col_parity_partial: the 2k columns of each square's top
// rows as axes, n_in inputs each.
void twin_rs_col_parity_partial(const uint8_t* top, uint8_t* partial, const uint8_t* Es,
                                const uint8_t* gexp, const uint8_t* glog, int k, int n_in, int n) {
  const uint64_t S = 512, row = 2 * uint64_t(k) * S;
  const TwinAxisSet cols{top, partial, S, row, S, row};
  twin_encode(&cols, Es, gexp, glog, uint32_t(k), uint32_t(n_in), 2 * uint32_t(k), 1,
              uint32_t(n), n_in * row, k * row);
}

// K9b: every thread of ctt_xor_reduce_scatter's grid (destination, batch,
// word).  Returns 0, or 1 where the C entry refuses.
int twin_xor_reduce_scatter(const long long* peers, int R, const long long* dsts,
                            const long long* offs, int n_dst, long long slab_bytes, int nb,
                            long long bstride) {
  using namespace ctt;
  if (R < 1 || R > int(kXorMaxShards) || (R & (R - 1)) || n_dst < 1 ||
      n_dst > int(kXorMaxShards) || nb < 1 || nb > 65535 || slab_bytes < 0 || bstride < 0 ||
      ((slab_bytes | bstride) & 15))
    return 1;
  XorSlabs a = {};
  uint64_t bad = 0;
  for (int j = 0; j < R; ++j) {
    a.peer[j] = reinterpret_cast<const uint8_t*>(uintptr_t(peers[j]));
    bad |= uint64_t(peers[j]);
  }
  for (int i = 0; i < n_dst; ++i) {
    a.dst[i] = reinterpret_cast<uint8_t*>(uintptr_t(dsts[i]));
    a.off[i] = uint64_t(offs[i]);
    bad |= uint64_t(dsts[i]) | a.off[i];
  }
  if (bad & 15u) return 1;
  a.bstride = uint64_t(bstride);
  const uint64_t words = uint64_t(slab_bytes) / 16;
  for (uint32_t i = 0; i < uint32_t(n_dst); ++i)
    for (uint64_t b = 0; b < uint64_t(nb); ++b)
      for (uint64_t w = 0; w < words; ++w) {
        switch (R) {
          case 1: xor_reduce_word<1>(a, i, b, words, w); break;
          case 2: xor_reduce_word<2>(a, i, b, words, w); break;
          case 4: xor_reduce_word<4>(a, i, b, words, w); break;
          default: xor_reduce_word<8>(a, i, b, words, w); break;
        }
      }
  return 0;
}

// K8a as ctt_rs_decode_matrices launches it: the blocks of `apb` axes one
// after another (apb as the C entry picks it, or given), each step of
// rs_decode_matrices_kernel run for its 256 threads before the next; the
// sums by warps of 8 items, each item's 4 lanes added as the shuffles add
// them.  Returns 0, or 1 where the C entry refuses.
int twin_rs_decode_matrices_grouped(const uint8_t* known, uint8_t* D, const uint8_t* gexp,
                                    const uint8_t* glog, int n, int k, int xor_const,
                                    int apb_arg) {
  using namespace ctt;
  if (n <= 0) return 0;
  const uint32_t lg_k = log2_exact(uint64_t(k > 0 ? k : 0));
  if (lg_k > 7 || (reinterpret_cast<uintptr_t>(D) & 15u)) return 1;
  const uint32_t K = uint32_t(k), nt = kDmThreads;
  const uint32_t apb = apb_arg > 0 ? uint32_t(apb_arg) : rs_dm_axes_per_block(uint32_t(n), K);
  if (apb * K > kDmMaxK) return 1;  // a block's shared memory holds 128 source points
  DmSmem sh;
  for (uint64_t a0 = 0; a0 < uint64_t(n); a0 += apb) {
    const uint32_t na = uint32_t(std::min<uint64_t>(apb, uint64_t(n) - a0));
    for (uint32_t tid = 0; tid < nt; ++tid)
      rs_dm_stage(sh, known, a0, na, K, uint32_t(xor_const), gexp, glog, tid, nt);
    const uint32_t items = 3 * na * K, per_warp = 32 / kDmGroup;
    for (uint32_t warp = 0; warp < nt / 32; ++warp)
      for (uint32_t it0 = warp * per_warp; it0 < items; it0 += nt / kDmGroup)
        for (uint32_t g = 0; g < per_warp; ++g) {
          uint32_t sum = 0;
          for (uint32_t part = 0; part < kDmGroup; ++part)
            sum += rs_dm_partial(sh, lg_k, na, uint32_t(xor_const), it0 + g, part);
          rs_dm_finish(sh, lg_k, na, it0 + g, sum);
        }
    for (uint32_t tid = 0; tid < nt; ++tid)
      rs_dm_write(sh, D + a0 * 2 * K * K, lg_k, na, uint32_t(xor_const), tid, nt);
  }
  return 0;
}

int twin_rs_decode_matrices(const uint8_t* known, uint8_t* D, const uint8_t* gexp,
                            const uint8_t* glog, int n, int k, int xor_const) {
  return twin_rs_decode_matrices_grouped(known, D, gexp, glog, n, k, xor_const, 0);
}

// K8b: the blocks of ctt_rs_decode_axes one after another, `gpb` output
// groups a block, each with rs_gf2_decode_kernel's prologue (the
// known-position bitmap, the ranks of the unknown positions, the range
// check) run thread by thread.
void twin_rs_decode_axes_grouped(uint8_t* eds, const uint8_t* D, const uint8_t* known,
                                 const int32_t* axes, const uint8_t* gexp, const uint8_t* glog,
                                 int n, int k, int cols, int gpb_arg) {
  using namespace ctt;
  const uint64_t S = 512, n2 = 2 * uint64_t(k);
  const uint64_t as = cols ? S : n2 * S, ps = cols ? n2 * S : S;
  const uint32_t K = uint32_t(k), groups = (K + kGf2Outputs - 1) / kGf2Outputs;
  const uint32_t gpb = uint32_t(gpb_arg);
  const std::vector<uint8_t> prod = twin_products(gexp, glog);
  std::vector<uint8_t> opos(K);
  for (int a = 0; a < n; ++a) {
    const uint8_t* kpos = known + size_t(a) * k;
    const uint8_t* Da = D + size_t(a) * 2 * k * k;
    uint32_t known_bits[8] = {0};
    bool out_of_range = axes[a] < 0 || uint32_t(axes[a]) >= 2 * K;
    for (uint32_t j = 0; j < K; ++j) {
      if (kpos[j] < 2 * K)
        known_bits[kpos[j] / 32] |= 1u << (kpos[j] % 32);
      else
        out_of_range = true;
    }
    if (out_of_range) continue;
    for (uint32_t p = 0; p < 2 * K; ++p) {
      if (rs_is_known(known_bits, p)) continue;
      const uint32_t r = rs_unknown_rank(known_bits, p);
      if (r < K) opos[r] = uint8_t(p);
    }
    for (uint32_t x = 0; x < (groups + gpb - 1) / gpb; ++x) {
      const uint32_t i0 = x * gpb * kGf2Outputs;
      const uint32_t n_out = K - i0 < gpb * kGf2Outputs ? K - i0 : gpb * kGf2Outputs;
      const uint32_t tiles = (n_out + kGf2Outputs - 1) / kGf2Outputs;
      const Gf2DecodeAxes ax{eds + uint32_t(axes[a]) * as, ps, kpos, opos.data() + i0, n_out};
      twin_gf2_gemm(ax, tiles, K, n_out,
                    [&](uint32_t o, uint32_t j) { return Da[opos[i0 + o] * K + j]; }, prod.data());
    }
  }
}

// K8b as ctt_rs_decode_axes launches it.
void twin_rs_decode_axes(uint8_t* eds, const uint8_t* D, const uint8_t* known,
                         const int32_t* axes, const uint8_t* gexp, const uint8_t* glog, int n,
                         int k, int cols) {
  const uint32_t groups = (uint32_t(k) + ctt::kGf2Outputs - 1) / ctt::kGf2Outputs;
  twin_rs_decode_axes_grouped(eds, D, known, axes, gexp, glog, n, k, cols,
                              int(ctt::gf2_groups_per_block(groups, uint32_t(n))));
}

// K8c: the warp vote as an OR over the 32 lanes of each cell.
void twin_rs_repair_verdicts(const uint8_t* repaired, const uint8_t* recomputed,
                             const uint8_t* provided, const uint8_t* avail, uint8_t* mismatch,
                             uint8_t* provided_mismatch, int cells) {
  for (int c = 0; c < cells; ++c) {
    uint32_t bits = 0;
    for (uint32_t lane = 0; lane < ctt::kVerdictLanes; ++lane)
      bits |= ctt::rs_verdict_lane(repaired, recomputed, provided, uint64_t(c), lane);
    mismatch[c] = (bits & 1u) ? 1 : 0;
    provided_mismatch[c] = (avail[c] && (bits & 2u)) ? 1 : 0;
  }
}

// The Leopard FFT extension (rs_leopard.cu).  The skew tables, as
// ctt_rs_leopard_tables: 0, or 1 where the C entry refuses.
int twin_rs_leopard_tables(const uint8_t* gexp, const uint8_t* glog, int k, uint32_t* out,
                           long long out_bytes) {
  if (k < 1 || ctt::log2_exact(uint64_t(k)) > ctt::kLeoMaxLogK ||
      out_bytes < static_cast<long long>(ctt::leo_table_bytes(uint32_t(k))))
    return 1;
  ctt::leo_group_tables(gexp, glog, uint32_t(k), out);
  return 0;
}

// squares uint8[n, k, k, 512] -> eds uint8[n, 2k, 2k, 512] in the order of
// ctt_rs_leopard_extend_batched's launches: every square's Q0 copy, then Q1
// and Q2 of each square (blockIdx.z = 2b + set), then Q3 of each.
void twin_rs_leopard_extend_batched(const uint8_t* squares, uint8_t* eds, const uint32_t* tab, int k,
                                    int n) {
  const uint64_t S = 512, K = uint64_t(k), sq_bytes = K * K * S, eds_bytes = 4 * K * K * S;
  for (int b = 0; b < n; ++b)
    for (uint64_t r = 0; r < K; ++r)
      memcpy(eds + b * eds_bytes + r * 2 * K * S, squares + b * sq_bytes + r * K * S, K * S);
  uint8_t* q1 = eds + K * S;
  uint8_t* q2 = eds + K * 2 * K * S;
  const ctt::LeoAxisSet sets[2] = {{squares, q1, K * S, S, 2 * K * S, S},
                                   {squares, q2, S, K * S, S, 2 * K * S}};
  twin_leo_encode(sets, tab, k, uint32_t(k), 2, 2 * uint32_t(n), sq_bytes, eds_bytes);
  const ctt::LeoAxisSet q1cols{q1, q2 + K * S, S, 2 * K * S, S, 2 * K * S};  // -> Q3
  twin_leo_encode(&q1cols, tab, k, uint32_t(k), 1, uint32_t(n), eds_bytes, eds_bytes);
}

void twin_rs_leopard_extend(const uint8_t* square, uint8_t* eds, const uint32_t* tab, int k) {
  twin_rs_leopard_extend_batched(square, eds, tab, k, 1);
}

// rows uint8[n, k, 512] -> out uint8[n, 2k, 512], as ctt_rs_leopard_extend_rows.
void twin_rs_leopard_extend_rows(const uint8_t* rows, uint8_t* out, const uint32_t* tab, int k,
                                 int n) {
  const uint64_t S = 512, K = uint64_t(k);
  for (int r = 0; r < n; ++r) memcpy(out + r * 2 * K * S, rows + r * K * S, K * S);
  const ctt::LeoAxisSet set{rows, out + K * S, K * S, S, 2 * K * S, S};
  twin_leo_encode(&set, tab, k, uint32_t(n), 1, 1, 0, 0);
}

// K8b under leopard-ff8 (rs_leopard_decode.cu).  The tables, as
// ctt_rs_leopard_decode_tables: 0, or 1 where the C entry refuses.
int twin_rs_leopard_decode_tables(const uint8_t* gexp, const uint8_t* glog, int k, uint32_t* out,
                                  long long out_bytes) {
  if (k < 1 || ctt::log2_exact(uint64_t(k)) > ctt::kLeoMaxLogK ||
      out_bytes < static_cast<long long>(ctt::leo_dec_table_bytes(uint32_t(k))))
    return 1;
  ctt::leo_decode_tables(gexp, glog, uint32_t(k), out);
  return 0;
}

// As ctt_rs_leopard_decode_axes launches it: 0, or 1 where it refuses.
int twin_rs_leopard_decode_axes(uint8_t* eds, const uint8_t* known, const int32_t* axes,
                                const uint32_t* tab, const uint8_t* gexp, const uint8_t* glog,
                                int n, int k, int cols) {
  if (k < 1 || ctt::log2_exact(uint64_t(k)) > ctt::kLeoMaxLogK || n > 65535) return 1;
  if (n <= 0) return 0;
  const uint64_t S = 512, n2 = 2 * uint64_t(k);
  const uint64_t as = cols ? S : n2 * S, ps = cols ? n2 * S : S;
  const uint32_t na = uint32_t(n);
  switch (ctt::log2_exact(n2)) {
    case 1: twin_leo_decode_k<1>(eds, known, axes, tab, gexp, glog, na, as, ps); break;
    case 2: twin_leo_decode_k<2>(eds, known, axes, tab, gexp, glog, na, as, ps); break;
    case 3: twin_leo_decode_k<3>(eds, known, axes, tab, gexp, glog, na, as, ps); break;
    case 4: twin_leo_decode_k<4>(eds, known, axes, tab, gexp, glog, na, as, ps); break;
    case 5: twin_leo_decode_k<5>(eds, known, axes, tab, gexp, glog, na, as, ps); break;
    case 6: twin_leo_decode_k<6>(eds, known, axes, tab, gexp, glog, na, as, ps); break;
    case 7: twin_leo_decode_k<7>(eds, known, axes, tab, gexp, glog, na, as, ps); break;
    case 8: twin_leo_decode_k<8>(eds, known, axes, tab, gexp, glog, na, as, ps); break;
    default: return 1;
  }
  return 0;
}

// K9a under leopard-ff8 (rs_leopard_partial.cu).  The shard's tables, as
// ctt_rs_leopard_partial_tables: 0, or 1 where the C entry refuses.
int twin_rs_leopard_partial_tables(const uint8_t* gexp, const uint8_t* glog, int k, int m, int j0,
                                   uint32_t* out, long long out_bytes) {
  if (ctt::leo_partial_bad_shard(k, m, j0) ||
      out_bytes < static_cast<long long>(ctt::leo_partial_table_bytes(uint32_t(k), uint32_t(m))))
    return 1;
  ctt::leo_partial_tables(gexp, glog, uint32_t(k), uint32_t(m), uint32_t(j0), out);
  return 0;
}

// top uint8[n, m, 2k, 512] -> partial uint8[n, k, 2k, 512], as
// ctt_rs_leopard_col_parity_partial launches it: 0, or 1 where it refuses.
int twin_rs_leopard_col_parity_partial(const uint8_t* top, uint8_t* partial, const uint32_t* tab,
                                       int k, int m, int j0, int n) {
  if (ctt::leo_partial_bad_shard(k, m, j0) || n < 0 || n > 65535) return 1;
  const uint32_t log_m = ctt::log2_exact(uint64_t(m)), j = uint32_t(j0), z = uint32_t(n);
  switch (ctt::log2_exact(uint64_t(k))) {
    case 0: twin_leo_partial_m<0>(log_m, top, partial, tab, j, z); break;
    case 1: twin_leo_partial_m<1>(log_m, top, partial, tab, j, z); break;
    case 2: twin_leo_partial_m<2>(log_m, top, partial, tab, j, z); break;
    case 3: twin_leo_partial_m<3>(log_m, top, partial, tab, j, z); break;
    case 4: twin_leo_partial_m<4>(log_m, top, partial, tab, j, z); break;
    case 5: twin_leo_partial_m<5>(log_m, top, partial, tab, j, z); break;
    case 6: twin_leo_partial_m<6>(log_m, top, partial, tab, j, z); break;
    case 7: twin_leo_partial_m<7>(log_m, top, partial, tab, j, z); break;
    default: return 1;
  }
  return 0;
}

}  // extern "C"
