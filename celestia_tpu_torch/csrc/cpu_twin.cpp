// CPU twin of the CUDA kernels: the same per-thread bodies (sha256.cuh,
// nmt.cuh, rs_extend.cuh, das_gather.cuh), compiled by g++ and looped over the thread
// indices on the host.  It lets the tests hold the kernels' arithmetic
// against the JAX package on a machine without a card; it is never on the
// port's path.  Build: g++ -O2 -std=c++17 -shared -fPIC cpu_twin.cpp.
#include <string.h>

#include <vector>

#include "das_gather.cuh"
#include "nmt.cuh"
#include "rs_extend.cuh"

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

void twin_nmt_leaf_digests(const uint8_t* eds, uint8_t* out, int n2) {
  for (uint32_t cell = 0; cell < uint32_t(n2) * uint32_t(n2); ++cell)
    ctt::nmt_leaf_body(eds, out, uint32_t(n2), cell);
}

void twin_nmt_combine_level(const uint8_t* in, uint8_t* out, long long ntrees, int m_out,
                            long long split, long long ts0, long long ns0, long long ts1,
                            long long ns1) {
  for (uint64_t idx = 0; idx < uint64_t(ntrees) * uint64_t(m_out); ++idx)
    ctt::nmt_combine_body(in, out, uint32_t(m_out), uint32_t(split), ts0, ns0, ts1, ns1, idx);
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

static void twin_axes(const uint8_t* in, uint8_t* out, const uint8_t* E, const uint8_t* gexp,
                      const uint8_t* glog, uint32_t k, uint64_t as, uint64_t ps, uint64_t oas,
                      uint64_t ops) {
  std::vector<uint8_t> exp_t(ctt::kExpEntries);
  std::vector<uint16_t> log_t(256), logE(ctt::kRsOutPerBlock * k);
  for (uint32_t i = 0; i < ctt::kExpEntries; ++i) exp_t[i] = ctt::rs_exp_entry(gexp, i);
  for (uint32_t v = 0; v < 256; ++v) log_t[v] = ctt::rs_log_entry(glog, v);
  for (uint32_t i0 = 0; i0 < k; i0 += ctt::kRsOutPerBlock) {
    const uint32_t nout = k - i0 < ctt::kRsOutPerBlock ? k - i0 : ctt::kRsOutPerBlock;
    for (uint32_t idx = 0; idx < nout * k; ++idx)
      logE[idx] = ctt::rs_log_entry(glog, E[(i0 + idx / k) * k + idx % k]);
    for (uint32_t a = 0; a < k; ++a)
      for (uint32_t t = 0; t < 128; ++t)
        ctt::rs_axis_body(in, out, logE.data(), nout, k, as, ps, oas, ops, a, i0, t, exp_t.data(),
                          log_t.data());
  }
}

void twin_rs_extend(const uint8_t* square, uint8_t* eds, const uint8_t* E, const uint8_t* gexp,
                    const uint8_t* glog, int k) {
  const uint64_t S = 512, K = uint64_t(k);
  for (uint64_t r = 0; r < K; ++r) memcpy(eds + r * 2 * K * S, square + r * K * S, K * S);
  uint8_t* q1 = eds + K * S;
  uint8_t* q2 = eds + K * 2 * K * S;
  uint8_t* q3 = q2 + K * S;
  twin_axes(square, q1, E, gexp, glog, k, K * S, S, 2 * K * S, S);
  twin_axes(square, q2, E, gexp, glog, k, S, K * S, S, 2 * K * S);
  twin_axes(q1, q3, E, gexp, glog, k, S, 2 * K * S, S, 2 * K * S);
}

}  // extern "C"
