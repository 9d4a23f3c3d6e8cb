// Per-lane bodies of `das_proof_gather` (das_gather.cu), shared with the g++
// CPU twin (cpu_twin.cpp).
//
// A gather *source* is one tensor of fixed-width items laid out as rows:
// item (row, idx) is the `width` bytes at base + row * row_stride +
// idx * item_stride.  An entry's sources are its NMT levels (90-byte
// digests; level 0 is the leaf grid read by rows), its RFC-6962 root-tree
// levels (32-byte hashes, one row each) and its EDS (512-byte shares).
//
// Two modes.  The *cell* mode takes a (row, tree_row, col) triple a DAS
// cell and derives the cell's items itself; its output record is share,
// aunts, siblings, padded to 16 bytes, and its threads write it, one
// 16-byte word each.  The *table* mode takes a host-built table of items, four int32
// each: (source, row, idx, offset of the item in the packed output).
//
// In the cell mode every byte moves in 16-byte words.  A *piece* is up to 16 source bytes
// bound for known positions of one output word; it is read from the
// aligned 16-byte words (granules) that hold it -- one, or two when it
// straddles a boundary -- and shifted into place in registers, so a source
// item at any byte offset (the digests sit at 2-byte-aligned ones) is read
// by 16-byte loads.  A granule is loaded only when it holds a byte of the
// piece: it then lies inside the tensor's allocation.
#pragma once

#include <stdint.h>

#include "sha256.cuh"  // CTT_HD, Word16

namespace ctt {

constexpr uint32_t kMaxGatherSrcs = 32;
constexpr uint32_t kGatherDigest = 90;  // an NMT node
constexpr uint32_t kGatherHash = 32;    // an RFC-6962 node
constexpr uint32_t kGatherShare = 512;
struct GatherSrc {
  const uint8_t* base;
  uint64_t row_stride;
  uint32_t item_stride;
  uint32_t width;
};

CTT_HD const uint8_t* gather_item(const GatherSrc& s, uint32_t row, uint32_t idx) {
  return s.base + static_cast<uint64_t>(row) * s.row_stride +
         static_cast<uint64_t>(idx) * s.item_stride;
}

// Source bytes a[0..n) bound for bytes p..p+n of an output word (n = 0: none).
struct Piece {
  const uint8_t* a;
  uint32_t p, n;
};

// The two granules from the one holding byte a - p: g[0] holds the piece's
// first byte or lies below it, g[1] follows.  Each is loaded only when it
// holds a byte of the piece (else zeros); the twin copies only the piece's
// own bytes.
CTT_HD void piece_load(const Piece& pc, Word16 g[2]) {
  g[0] = Word16{0u, 0u, 0u, 0u};
  g[1] = g[0];
  if (!pc.n) return;
  const uintptr_t first = reinterpret_cast<uintptr_t>(pc.a), last = first + pc.n - 1u;
  const uintptr_t lo = (first - pc.p) & ~uintptr_t(15);
#ifdef __CUDA_ARCH__
  const Word16* w = reinterpret_cast<const Word16*>(lo);
  if (lo + 15u >= first) g[0] = w[0];
  if (lo + 16u <= last) g[1] = w[1];
#else
  uint8_t* bytes = reinterpret_cast<uint8_t*>(g);
  for (uintptr_t x = first; x <= last; ++x) bytes[x - lo] = *reinterpret_cast<const uint8_t*>(x);
#endif
}

// Bytes lo..hi of a 16-byte word that fall in its 32-bit word e, as a mask.
CTT_HD uint32_t byte_mask(uint32_t lo, uint32_t hi, uint32_t e) {
  const int32_t a = static_cast<int32_t>(lo) - static_cast<int32_t>(4u * e);
  const int32_t b = static_cast<int32_t>(hi) - static_cast<int32_t>(4u * e);
  const uint32_t ma = a <= 0 ? ~0u : (a >= 4 ? 0u : ~0u << (8 * a));
  const uint32_t mb = b >= 4 ? ~0u : (b <= 0 ? 0u : ~0u >> (8 * (4 - b)));
  return ma & mb;
}

// OR the piece, read from its granules, into its positions of v.  The 16
// bytes from a - p are picked out of the granules' 32 by word selects and
// one funnel shift a word (every index a constant: registers only).
CTT_HD void piece_merge(const Piece& pc, const Word16 g[2], uint32_t v[4]) {
  if (!pc.n) return;
  const uint32_t s = static_cast<uint32_t>((reinterpret_cast<uintptr_t>(pc.a) - pc.p) & 15u);
  const uint32_t w[8] = {g[0].x, g[0].y, g[0].z, g[0].w, g[1].x, g[1].y, g[1].z, g[1].w};
  uint32_t t[6], u[5];
#pragma unroll
  for (uint32_t e = 0; e < 6; ++e) t[e] = (s & 8u) ? w[e + 2] : w[e];
#pragma unroll
  for (uint32_t e = 0; e < 5; ++e) u[e] = (s & 4u) ? t[e + 1] : t[e];
  const uint32_t r = 8u * (s & 3u);
#pragma unroll
  for (uint32_t e = 0; e < 4; ++e) {
#ifdef __CUDA_ARCH__
    const uint32_t x = __funnelshift_r(u[e], u[e + 1], r);
#else
    const uint32_t x = r ? (u[e] >> r) | (u[e + 1] << (32u - r)) : u[e];
#endif
    v[e] |= x & byte_mask(pc.p, pc.p + pc.n, e);
  }
}

CTT_HD void store_word16(uint8_t* dst, const uint32_t v[4]) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<Word16*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
#else
  for (uint32_t e = 0; e < 4; ++e) st32(dst + 4 * e, v[e]);
#endif
}

// --- the table mode ----------------------------------------------------------

// Lane `lane` of `lanes` copies item `item`: as 16-byte words when its
// source, its place in `out` and its width are multiples of 16 (shares,
// hashes, and every item of a table laid out for it), else byte by byte
// (a digest, 90 bytes at a 2-byte-aligned offset).  `out` is 16-byte
// aligned.
CTT_HD void das_gather_body(const GatherSrc* srcs, const int32_t* items, uint8_t* out,
                            uint32_t item, uint32_t lane, uint32_t lanes) {
  const int32_t* it = items + 4u * item;
  const GatherSrc& s = srcs[it[0]];
  const uint8_t* src = gather_item(s, static_cast<uint32_t>(it[1]), static_cast<uint32_t>(it[2]));
  uint8_t* dst = out + static_cast<uint32_t>(it[3]);
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) | s.width) & 15u) == 0) {
    for (uint32_t w = lane; w < s.width / 16u; w += lanes) {
#ifdef __CUDA_ARCH__
      reinterpret_cast<Word16*>(dst)[w] = reinterpret_cast<const Word16*>(src)[w];
#else
      for (uint32_t b = 16u * w; b < 16u * w + 16u; ++b) dst[b] = src[b];
#endif
    }
  } else {
    for (uint32_t b = lane; b < s.width; b += lanes) dst[b] = src[b];
  }
}

// --- the cell mode -----------------------------------------------------------

// Where a cell's items come from: NMT level l is source sib0 + l (row =
// the cell's tree row), root-tree level j is source aunt0 + j (row 0), the
// EDS is source `share`.  n_sib = log2(2k) siblings, n_aunt = log2(4k)
// aunts.  The record is the share (512 B), the aunts (32 B each), the
// siblings (90 B each) and zeros up to `words` 16-byte words.
struct CellArgs {
  uint32_t n_sib, sib0, n_aunt, aunt0, share;
  uint32_t sib_off;  // 512 + 32 n_aunt
  uint32_t words;    // ceil((sib_off + 90 n_sib) / 16)
};

CTT_HD CellArgs cell_args(uint32_t n_sib, uint32_t sib0, uint32_t n_aunt, uint32_t aunt0,
                          uint32_t share) {
  CellArgs a{n_sib, sib0, n_aunt, aunt0, share, 0u, 0u};
  a.sib_off = kGatherShare + kGatherHash * n_aunt;
  a.words = (a.sib_off + kGatherDigest * n_sib + 15u) / 16u;
  return a;
}

// The threads of a cell: one per 16-byte word of its record, in whole warps.
CTT_HD uint32_t cell_lanes(const CellArgs& a) { return (a.words + 31u) / 32u * 32u; }

// The NMT level of sibling j of column c's single-cell range proof, in the
// traversal order of a range proof (da/proof.py nmt_range_proof_from_levels):
// the left siblings (bit l of c set) from the top level down, then the
// right siblings (bit l clear) from the bottom level up.  Its node is
// (c >> l) ^ 1.
CTT_HD uint32_t cell_sibling_level(uint32_t c, uint32_t n_sib, uint32_t j) {
  uint32_t left = 0;
  for (uint32_t l = 0; l < n_sib; ++l) left += (c >> l) & 1u;
  if (j < left) {
    for (uint32_t l = n_sib; l-- > 0;)
      if (((c >> l) & 1u) && j-- == 0) return l;
  } else {
    j -= left;
    for (uint32_t l = 0; l < n_sib; ++l)
      if (!((c >> l) & 1u) && j-- == 0) return l;
  }
  return 0;
}

// The pieces of word w of the record of the cell at (row, tree, col): one
// from the share or an aunt (both whole 16-byte words of their item), or
// from one or two siblings (a 90-byte digest ends inside a word); none in
// the padding.
CTT_HD void cell_pieces(const CellArgs& a, const GatherSrc* srcs, uint32_t row, uint32_t tree,
                        uint32_t col, uint32_t w, Piece pc[2]) {
  const uint32_t b = 16u * w;
  pc[0] = Piece{nullptr, 0u, 0u};
  pc[1] = pc[0];
  if (b < kGatherShare) {
    pc[0] = Piece{gather_item(srcs[a.share], row, col) + b, 0u, 16u};
  } else if (b < a.sib_off) {
    const uint32_t j = (b - kGatherShare) / kGatherHash, off = (b - kGatherShare) % kGatherHash;
    pc[0] = Piece{gather_item(srcs[a.aunt0 + j], 0u, (row >> j) ^ 1u) + off, 0u, 16u};
  } else {
    const uint32_t q = b - a.sib_off, j = q / kGatherDigest, off = q % kGatherDigest;
    if (j >= a.n_sib) return;
    const uint32_t n0 = kGatherDigest - off < 16u ? kGatherDigest - off : 16u;
    const uint32_t l0 = cell_sibling_level(col, a.n_sib, j);
    pc[0] = Piece{gather_item(srcs[a.sib0 + l0], tree, (col >> l0) ^ 1u) + off, 0u, n0};
    if (n0 < 16u && j + 1u < a.n_sib) {
      const uint32_t l1 = cell_sibling_level(col, a.n_sib, j + 1u);
      pc[1] = Piece{gather_item(srcs[a.sib0 + l1], tree, (col >> l1) ^ 1u), n0, 16u - n0};
    }
  }
}

// Thread w of the cell's: word w of the cell's record `rec` (16 * words
// bytes), its loads -- one 16-byte granule for a word of the share or an
// aunt, up to four for a word of the siblings -- all issued before its one
// store.  Threads past the record do nothing.
CTT_HD void das_cell_word(const CellArgs& a, const GatherSrc* srcs, uint32_t row, uint32_t tree,
                          uint32_t col, uint8_t* rec, uint32_t w) {
  if (w >= a.words) return;
  Piece pc[2];
  cell_pieces(a, srcs, row, tree, col, w, pc);
  Word16 gr[2][2];
  piece_load(pc[0], gr[0]);
  piece_load(pc[1], gr[1]);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  piece_merge(pc[0], gr[0], v);
  piece_merge(pc[1], gr[1], v);
  store_word16(rec + 16u * w, v);
}

}  // namespace ctt
