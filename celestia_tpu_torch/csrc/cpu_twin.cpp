// CPU twin of the CUDA kernels: the same per-thread bodies (sha256.cuh,
// nmt.cuh, rs_extend.cuh, rs_decode.cuh, rs_sharded.cuh, das_gather.cuh),
// compiled by g++ and
// looped over the thread
// indices on the host.  It lets the tests hold the kernels' arithmetic
// against the JAX package on a machine without a card; it is never on the
// port's path.  Build: g++ -O2 -std=c++17 -shared -fPIC cpu_twin.cpp.
#include <string.h>

#include <vector>

#include "das_gather.cuh"
#include "nmt.cuh"
#include "rs_decode.cuh"
#include "rs_extend.cuh"
#include "rs_sharded.cuh"

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

// K2 over a window of n_rows EDS rows from row0 (of each of batch EDSs).
void twin_nmt_leaf_digests_window(const uint8_t* eds, uint8_t* out, int n2, int batch, int row0,
                                  int n_rows) {
  for (uint32_t cell = 0; cell < uint32_t(batch) * uint32_t(n_rows) * uint32_t(n2); ++cell)
    ctt::nmt_leaf_body(eds, out, uint32_t(n2), uint32_t(row0), uint32_t(n_rows), cell);
}

void twin_nmt_leaf_digests_batched(const uint8_t* eds, uint8_t* out, int n2, int batch) {
  twin_nmt_leaf_digests_window(eds, out, n2, batch, 0, n2);
}

void twin_nmt_leaf_digests(const uint8_t* eds, uint8_t* out, int n2) {
  twin_nmt_leaf_digests_batched(eds, out, n2, 1);
}

void twin_nmt_combine_level_batched(const uint8_t* in, uint8_t* out, long long ntrees, int m_out,
                                    long long split, long long ts0, long long ns0, long long ts1,
                                    long long ns1, long long tpb, long long bs) {
  for (uint64_t idx = 0; idx < uint64_t(ntrees) * uint64_t(m_out); ++idx)
    ctt::nmt_combine_body(in, out, uint32_t(m_out), uint32_t(split), ts0, ns0, ts1, ns1, tpb, bs,
                          idx);
}

void twin_nmt_combine_level(const uint8_t* in, uint8_t* out, long long ntrees, int m_out,
                            long long split, long long ts0, long long ns0, long long ts1,
                            long long ns1) {
  twin_nmt_combine_level_batched(in, out, ntrees, m_out, split, ts0, ns0, ts1, ns1, ntrees, 0);
}

// levels: uint8[batch, 2n - 1, 32] (leaf hashes first, root last), as
// ctt_rfc6962_root writes them.
void twin_rfc6962_levels(const uint8_t* leaves, uint8_t* levels, int batch, int n) {
  std::vector<uint8_t> nodes(size_t(n) * 32);
  for (int b = 0; b < batch; ++b) {
    memcpy(nodes.data(), leaves + size_t(b) * n * 32, size_t(n) * 32);
    uint8_t* level = levels + size_t(b) * (2 * size_t(n) - 1) * 32;
    memcpy(level, nodes.data(), size_t(n) * 32);
    for (uint32_t m = uint32_t(n); m > 1; m >>= 1) {
      std::vector<uint32_t> st(size_t(m / 2) * 8);
      for (uint32_t j = 0; j < m / 2; ++j) ctt::rfc6962_inner_body(nodes.data(), j, &st[8 * j]);
      for (uint32_t j = 0; j < m / 2; ++j) ctt::store_digest(&st[8 * j], nodes.data() + 32 * j);
      level += size_t(m) * 32;
      memcpy(level, nodes.data(), size_t(m / 2) * 32);
    }
  }
}

// The root alone: the last row of each tree's levels.
void twin_rfc6962_root(const uint8_t* leaves, uint8_t* out, int batch, int n) {
  const size_t rows = 2 * size_t(n) - 1;
  std::vector<uint8_t> levels(size_t(batch) * rows * 32);
  twin_rfc6962_levels(leaves, levels.data(), batch, n);
  for (int b = 0; b < batch; ++b)
    memcpy(out + size_t(b) * 32, levels.data() + (size_t(b) * rows + rows - 1) * 32, 32);
}

// srcs: n_srcs x 4 int64 (base pointer, row stride, item stride, width), as
// ctt_das_proof_gather takes them; one "lane" per item.
void twin_das_proof_gather(const long long* srcs, int n_srcs, const int32_t* items, int n_items,
                           uint8_t* out) {
  std::vector<ctt::GatherSrc> table(static_cast<size_t>(n_srcs));
  for (int i = 0; i < n_srcs; ++i)
    table[i] = ctt::GatherSrc{reinterpret_cast<const uint8_t*>(uintptr_t(srcs[4 * i])),
                              uint64_t(srcs[4 * i + 1]), uint32_t(srcs[4 * i + 2]),
                              uint32_t(srcs[4 * i + 3])};
  for (int i = 0; i < n_items; ++i) ctt::das_gather_body(table.data(), items, out, i, 0, 1);
}

// n_axes axes of k parity positions each from n_in inputs; E uint8[k, n_in]
// (n_in = k for K5, k/R for K9a), as rs_encode_axes_kernel.
static void twin_axes(const uint8_t* in, uint8_t* out, const uint8_t* E, const uint8_t* gexp,
                      const uint8_t* glog, uint32_t k, uint32_t n_in, uint64_t as, uint64_t ps,
                      uint64_t oas, uint64_t ops, uint32_t n_axes) {
  std::vector<uint8_t> exp_t(ctt::kExpEntries);
  std::vector<uint16_t> log_t(256), logE(ctt::kRsOutPerBlock * n_in);
  for (uint32_t i = 0; i < ctt::kExpEntries; ++i) exp_t[i] = ctt::rs_exp_entry(gexp, i);
  for (uint32_t v = 0; v < 256; ++v) log_t[v] = ctt::rs_log_entry(glog, v);
  for (uint32_t i0 = 0; i0 < k; i0 += ctt::kRsOutPerBlock) {
    const uint32_t nout = k - i0 < ctt::kRsOutPerBlock ? k - i0 : ctt::kRsOutPerBlock;
    for (uint32_t idx = 0; idx < nout * n_in; ++idx)
      logE[idx] = ctt::rs_log_entry(glog, E[(i0 + idx / n_in) * n_in + idx % n_in]);
    for (uint32_t a = 0; a < n_axes; ++a)
      for (uint32_t t = 0; t < 128; ++t)
        ctt::rs_axis_body(in, out, logE.data(), nout, n_in, as, ps, oas, ops, a, i0, t,
                          exp_t.data(), log_t.data());
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
  for (int b = 0; b < n; ++b) {
    const uint8_t* q0 = squares + b * sq_bytes;
    uint8_t* out = eds + b * eds_bytes;
    twin_axes(q0, out + K * S, E, gexp, glog, k, k, K * S, S, 2 * K * S, S, k);
    twin_axes(q0, out + K * 2 * K * S, E, gexp, glog, k, k, S, K * S, S, 2 * K * S, k);
  }
  for (int b = 0; b < n; ++b) {
    uint8_t* q1 = eds + b * eds_bytes + K * S;
    twin_axes(q1, q1 + 2 * K * K * S, E, gexp, glog, k, k, S, 2 * K * S, S, 2 * K * S, k);  // -> Q3
  }
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
  twin_axes(rows, out + K * S, E, gexp, glog, k, k, K * S, S, 2 * K * S, S, uint32_t(n));
}

// K9a, as ctt_rs_col_parity_partial: the 2k columns of each square's top
// rows as axes, n_in inputs each.
void twin_rs_col_parity_partial(const uint8_t* top, uint8_t* partial, const uint8_t* Es,
                                const uint8_t* gexp, const uint8_t* glog, int k, int n_in, int n) {
  const uint64_t S = 512, row = 2 * uint64_t(k) * S;
  for (int b = 0; b < n; ++b)
    twin_axes(top + b * n_in * row, partial + b * k * row, Es, gexp, glog, uint32_t(k),
              uint32_t(n_in), S, row, S, row, 2 * uint32_t(k));
}

// K9b: every thread of ctt_xor_reduce_slabs.
void twin_xor_reduce_slabs(const uint8_t* staged, uint8_t* out, int R, long long nbytes) {
  const uint64_t n_words = uint64_t(nbytes) / 16;
  for (uint64_t w = 0; w < n_words; ++w) ctt::xor_reduce_body(staged, out, uint32_t(R), n_words, w);
}

// K8a: one "block" per axis, as ctt_rs_decode_matrices launches them.
void twin_rs_decode_matrices(const uint8_t* known, uint8_t* D, const uint8_t* gexp,
                             const uint8_t* glog, int n, int k, int xor_const) {
  std::vector<uint8_t> src(static_cast<size_t>(k));
  std::vector<uint16_t> denom(static_cast<size_t>(k));
  for (int a = 0; a < n; ++a) {
    for (int j = 0; j < k; ++j) src[j] = uint8_t(known[size_t(a) * k + j] ^ xor_const);
    for (int j = 0; j < k; ++j) denom[j] = uint16_t(ctt::rs_denom_log(src.data(), k, j, glog));
    for (int i = 0; i < 2 * k; ++i)
      ctt::rs_decode_row(src.data(), denom.data(), k, uint32_t(i ^ xor_const), gexp, glog,
                         D + (size_t(a) * 2 * k + i) * k);
  }
}

// K8b: the blocks of ctt_rs_decode_axes one after another.
void twin_rs_decode_axes(uint8_t* eds, const uint8_t* D, const uint8_t* known,
                         const int32_t* axes, const uint8_t* gexp, const uint8_t* glog, int n,
                         int k, int cols) {
  const uint64_t S = 512, n2 = 2 * uint64_t(k);
  const uint64_t as = cols ? S : n2 * S, ps = cols ? n2 * S : S;
  std::vector<uint8_t> exp_t(ctt::kExpEntries), opos(static_cast<size_t>(k));
  std::vector<uint16_t> log_t(256), logD(ctt::kRsOutPerBlock * size_t(k));
  for (uint32_t i = 0; i < ctt::kExpEntries; ++i) exp_t[i] = ctt::rs_exp_entry(gexp, i);
  for (uint32_t v = 0; v < 256; ++v) log_t[v] = ctt::rs_log_entry(glog, v);
  for (int a = 0; a < n; ++a) {
    const uint8_t* kpos = known + size_t(a) * k;
    const uint8_t* Da = D + size_t(a) * 2 * k * k;
    ctt::rs_unknown_positions(kpos, k, opos.data());
    if (!ctt::rs_axis_in_bounds(kpos, k, axes[a])) continue;
    for (uint32_t i0 = 0; i0 < uint32_t(k); i0 += ctt::kRsOutPerBlock) {
      const uint32_t nout = k - i0 < ctt::kRsOutPerBlock ? k - i0 : ctt::kRsOutPerBlock;
      for (uint32_t idx = 0; idx < nout * k; ++idx)
        logD[idx] = ctt::rs_log_entry(glog, Da[opos[i0 + idx / k] * k + idx % k]);
      for (uint32_t t = 0; t < 128; ++t)
        ctt::rs_decode_body(eds, logD.data(), kpos, opos.data() + i0, nout, k, as, ps,
                            uint32_t(axes[a]), t, exp_t.data(), log_t.data());
    }
  }
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

}  // extern "C"
