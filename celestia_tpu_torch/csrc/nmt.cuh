// Per-thread bodies of the NMT kernels (K2 leaf digests, K3 one level of
// the namespace-aware reduction) and of the RFC-6962 inner node (K4),
// shared by nmt.cu / rfc6962.cu and the g++ CPU twin (cpu_twin.cpp).
//
// Digest layout (ops/nmt.py): leaf = ns || ns || sha256(0x00 || ns || share),
// node = l.min || max || sha256(0x01 || l || r) with max = l.max when r.min
// is the parity namespace (IgnoreMaxNamespace), else r.max.  29 + 29 + 32
// = 90 bytes.
#pragma once

#include "sha256.cuh"

namespace ctt {

constexpr uint32_t kNs = 29;
constexpr uint32_t kShare = 512;
constexpr uint32_t kDigest = 2 * kNs + 32;  // 90
constexpr uint32_t kLeafMsg = 1 + kNs + kShare;  // 542
constexpr uint32_t kNodeMsg = 1 + 2 * kDigest;   // 181

// `0x00 || prefix || share`, prefix = the share's own namespace (its first
// 29 bytes) inside Q0 and 29 x 0xFF elsewhere (nmt_wrapper.go:93-114).
struct LeafSrc {
  const uint8_t* share;
  bool q0;
  CTT_HD uint32_t byte(uint32_t p) const {
    if (p == 0) return 0u;
    if (p <= kNs) return q0 ? share[p - 1] : 0xFFu;
    return share[p - 1 - kNs];
  }
  CTT_HD uint32_t word(uint32_t p) const {
    if (p > kNs) return load_be(share + (p - 1 - kNs));
    if (p >= 1 && p + 3 <= kNs) return q0 ? load_be(share + (p - 1)) : 0xFFFFFFFFu;
    return (byte(p) << 24) | (byte(p + 1) << 16) | (byte(p + 2) << 8) | byte(p + 3);
  }
};

// `tag || l[0..half) || r[0..half)`: an NMT node (tag 0x01, half 90) or an
// RFC-6962 inner node (tag 0x01, half 32).
struct PairSrc {
  const uint8_t* l;
  const uint8_t* r;
  uint32_t half;
  CTT_HD uint32_t byte(uint32_t p) const {
    if (p == 0) return 1u;
    if (p <= half) return l[p - 1];
    return r[p - 1 - half];
  }
  CTT_HD uint32_t word(uint32_t p) const {
    if (p >= 1 && p + 3 <= half) return load_be(l + (p - 1));
    if (p > half) return load_be(r + (p - 1 - half));
    return (byte(p) << 24) | (byte(p + 1) << 16) | (byte(p + 2) << 8) | byte(p + 3);
  }
};

// K2: the leaf digest of cell `cell` of a window of n_rows EDS rows that
// starts at EDS row row0 (row-major over n_rows x n2, and over a batch of
// windows before that) into out[cell] of a (..., n_rows, n2, 90) grid.  The
// whole EDS is the window row0 = 0, n_rows = n2; a K9 shard hashes its top
// rows (row0 = shard * k/R) and its bottom rows (row0 = k + shard * k/R),
// so the Q0 rule reads global coordinates (celestia_tpu/parallel/
// sharded.py:106-114).  Each cell is hashed once: row tree r reads grid row
// r, column tree c reads grid column c -- the same bytes the JAX program
// hashes twice (ops/nmt.py:100).
CTT_HD void nmt_leaf_body(const uint8_t* eds, uint8_t* out, uint32_t n2, uint32_t row0,
                          uint32_t n_rows, uint32_t cell) {
  const uint32_t r = row0 + (cell / n2) % n_rows, c = cell % n2, k = n2 / 2;
  const bool q0 = r < k && c < k;
  const uint8_t* share = eds + static_cast<uint64_t>(cell) * kShare;
  uint32_t st[8];
  sha256_message(LeafSrc{share, q0}, kLeafMsg, st);
  uint8_t* o = out + static_cast<uint64_t>(cell) * kDigest;
  for (uint32_t i = 0; i < kNs; ++i) {
    const uint8_t v = q0 ? share[i] : 0xFF;
    o[i] = v;
    o[kNs + i] = v;
  }
  store_digest(st, o + 2 * kNs);
}

// K3: parent `idx` of one level.  Output is contiguous (ntrees, m_out, 90).
// Trees come in groups of `tpb` whose inputs lie `bs` bytes apart; tree u
// of a group has node i at u*ts + i*ns with (ts, ns) = (ts0, ns0) for
// u < split and ((u - split)*ts1, ns1) beyond, so the first level can read
// a leaf grid by rows (trees 0..2k) and by columns (trees 2k..4k), for one
// grid (tpb = ntrees) or a batch of grids (tpb = 4k).
CTT_HD void nmt_combine_body(const uint8_t* in, uint8_t* out, uint32_t m_out, uint32_t split,
                             uint64_t ts0, uint64_t ns0, uint64_t ts1, uint64_t ns1,
                             uint64_t tpb, uint64_t bs, uint64_t idx) {
  const uint64_t t = idx / m_out, j = idx % m_out;
  const uint64_t g = t / tpb, u = t % tpb;
  const uint64_t base = g * bs + (u < split ? u * ts0 : (u - split) * ts1);
  const uint64_t ns = u < split ? ns0 : ns1;
  const uint8_t* l = in + base + 2 * j * ns;
  const uint8_t* r = l + ns;
  uint32_t st[8];
  sha256_message(PairSrc{l, r, kDigest}, kNodeMsg, st);
  bool r_parity = true;
  for (uint32_t i = 0; i < kNs; ++i) r_parity = r_parity && r[i] == 0xFF;
  uint8_t* o = out + idx * kDigest;
  const uint8_t* mx = r_parity ? l + kNs : r + kNs;
  for (uint32_t i = 0; i < kNs; ++i) {
    o[i] = l[i];
    o[kNs + i] = mx[i];
  }
  store_digest(st, o + 2 * kNs);
}

// K4: sha256(0x01 || nodes[2j] || nodes[2j+1]) over 32-byte nodes.
CTT_HD void rfc6962_inner_body(const uint8_t* nodes, uint32_t j, uint32_t st[8]) {
  sha256_message(PairSrc{nodes + 64u * j, nodes + 64u * j + 32u, 32u}, 65u, st);
}

}  // namespace ctt
