// The NMT kernels' pieces (K2 leaf digests, K3 the namespace-aware level
// reduction) and the RFC-6962 tree's (K4), shared by nmt.cu / rfc6962.cu
// and the g++ CPU twin (cpu_twin.cpp).
//
// K2 and K3 are block-cooperative: a block stages its inputs in shared
// memory, hashes, and writes its outputs back with wide copies, with
// barriers between the steps.  Each step is a function of one thread index
// here; the kernels run the steps on their threads with __syncthreads()
// between them, and the twin runs a block by looping each step over every
// thread index, so the CPU tests run the kernels' own index maps.
//
// K4 (the RFC-6962 tree) is a block-cooperative kernel of the same kind:
// the leaves staged, one thread a leaf hash, the levels reduced in shared
// memory (the 65-byte inner node is sha256.cuh's sha256_inner65).
//
// Digest layout (ops/nmt.py): leaf = ns || ns || sha256(0x00 || ns || share),
// node = l.min || max || sha256(0x01 || l || r) with max = l.max when r.min
// is the parity namespace (IgnoreMaxNamespace), else r.max.  29 + 29 + 32
// = 90 bytes.
#pragma once

#include <string.h>

#include "sha256.cuh"

namespace ctt {

constexpr uint32_t kNs = 29;
constexpr uint32_t kShare = 512;
constexpr uint32_t kDigest = 2 * kNs + 32;  // 90

// --- cooperative copies --------------------------------------------------

// The widest unit (16, 8, 4 or 2 bytes) that divides x (addresses and
// lengths or'ed together); at least 2, since every node is 90 bytes and the
// entry points refuse odd addresses.
CTT_HD uint32_t copy_unit(uint64_t x) {
  x |= 16u;
  const uint32_t u = static_cast<uint32_t>(x & (~x + 1u));
  return u < 2u ? 2u : u;
}

#ifdef __CUDACC__
template <uint32_t U> struct UnitWord;
template <> struct UnitWord<16> { using T = uint4; };
template <> struct UnitWord<8> { using T = uint2; };
template <> struct UnitWord<4> { using T = uint32_t; };
template <> struct UnitWord<2> { using T = uint16_t; };
#endif

template <uint32_t U>
CTT_HD void copy_units(uint8_t* d, const uint8_t* s, uint32_t n, uint32_t i0, uint32_t step) {
  for (uint32_t i = i0; i < n; i += step) {
#ifdef __CUDA_ARCH__
    using T = typename UnitWord<U>::T;
    reinterpret_cast<T*>(d)[i] = reinterpret_cast<const T*>(s)[i];
#else
    memcpy(d + i * U, s + i * U, U);
#endif
  }
}

// Thread i0 of `step` copies its units of the n bytes at s to d: units
// i0, i0 + step, ...; n is a multiple of `unit`, d and s are aligned to it.
// Neighbouring threads take neighbouring units, so a warp's access is one
// contiguous run (coalesced in global memory, conflict-free in shared).
CTT_HD void copy_bytes(uint8_t* d, const uint8_t* s, uint32_t n, uint32_t unit, uint32_t i0,
                       uint32_t step) {
  switch (unit) {
    case 16: copy_units<16>(d, s, n / 16u, i0, step); break;
    case 8: copy_units<8>(d, s, n / 8u, i0, step); break;
    case 4: copy_units<4>(d, s, n / 4u, i0, step); break;
    default: copy_units<2>(d, s, n / 2u, i0, step); break;
  }
}

// --- K3: the level reduction -------------------------------------------

// A block reduces up to kNmtTileLeaves level-0 nodes: one tree of 512
// leaves, or 512 / m trees of m leaves (no tree is taller: an EDS axis has
// at most 256 leaves).  Level 0 is staged in buffer A, level 1 written to
// B, level 2 to A, ...; every level goes out to the packed output as soon
// as the block has it.
constexpr uint32_t kNmtLgTile = 9;
constexpr uint32_t kNmtTileLeaves = 1u << kNmtLgTile;
constexpr uint32_t kNmtThreads = kNmtTileLeaves / 2;  // one thread a level-1 parent
// both buffers, and 16 bytes after them that a node's word loads may touch
constexpr uint32_t kNmtSmemBytes = (kNmtTileLeaves + kNmtTileLeaves / 2) * kDigest + 16;

// One launch.  Trees come in groups of tpb whose inputs lie bs bytes
// apart; tree u of a group has node i at u*ts + i*ns with (ts, ns) = set
// 0's for u < split and ((u - split)*ts1, ns1) beyond, so one launch reads
// a leaf grid by rows (trees 0..2k) and by columns (trees 2k..4k), for one
// grid (tpb = ntrees) or a batch of grids (tpb = 4k).  The packed output
// holds level j = 1..n_levels as uint8[ntrees, m >> j, 90] from byte
// ntrees * (m - (m >> (j - 1))) * 90 on.
struct NmtReduceArgs {
  const uint8_t* in;
  uint8_t* out;
  uint64_t ts0, ns0;      // stride set 0: bytes between trees, between nodes
  uint64_t ts1, ns1;      // stride set 1
  uint64_t bs;            // bytes between groups
  uint64_t ntrees;        // trees of the launch
  uint32_t split, tpb;    // trees of set 0 in a group; trees a group
  uint32_t lg_m;          // log2 of a tree's leaves
  uint32_t per_block;     // trees a block
  uint32_t blocks0;       // blocks of set 0 in a group
  uint32_t n_levels;      // levels written, 1 .. lg_m
};

// Fill `a` for one launch; returns the blocks of a group (the grid's x;
// the groups, ntrees / tpb, are its y), or 0 for what the kernel does not
// take: m not a power of two in 2..512, n_levels outside 1..log2 m, groups
// that do not divide the trees, odd addresses or strides (a node loads 2
// bytes at a time at least), or several trees a block whose nodes
// interleave neither by rows (ns = 90) nor by columns (ts = 90).
CTT_HD uint32_t nmt_reduce_setup(NmtReduceArgs* a, const uint8_t* in, uint8_t* out,
                                 uint64_t ntrees, uint32_t m, uint32_t n_levels, uint64_t split,
                                 uint64_t ts0, uint64_t ns0, uint64_t ts1, uint64_t ns1,
                                 uint64_t tpb, uint64_t bs) {
  const uint32_t lg_m = log2_exact(m);
  if (lg_m == 0 || lg_m > kNmtLgTile || tpb == 0 || ntrees == 0 || ntrees % tpb ||
      split > tpb || tpb > 0xFFFFFFFFull)
    return 0;
  if (n_levels < 1 || n_levels > lg_m) return 0;
  if ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out) | ts0 | ns0 | ts1 |
       ns1 | bs) & 1u)
    return 0;
  a->in = in;
  a->out = out;
  a->ts0 = ts0;
  a->ns0 = ns0;
  a->ts1 = ts1;
  a->ns1 = ns1;
  a->bs = bs;
  a->ntrees = ntrees;
  a->lg_m = lg_m;
  a->split = static_cast<uint32_t>(split);
  a->tpb = static_cast<uint32_t>(tpb);
  a->per_block = kNmtTileLeaves >> lg_m;
  a->n_levels = n_levels;
  uint64_t blocks[2];
  for (uint32_t set = 0; set < 2; ++set) {
    const uint64_t trees = set ? tpb - split : split;
    const uint64_t ts = set ? ts1 : ts0, ns = set ? ns1 : ns0;
    if (trees && a->per_block > 1 && ns != kDigest && ts != kDigest) return 0;
    blocks[set] = (trees + a->per_block - 1) / a->per_block;
  }
  if (blocks[0] + blocks[1] > 0x7FFFFFFFull) return 0;
  a->blocks0 = static_cast<uint32_t>(blocks[0]);
  return static_cast<uint32_t>(blocks[0] + blocks[1]);
}

// What block (bx, group g) reduces: n trees from t0 on (t0 counted over
// the launch), staged as `runs` runs of `len` bytes, `stride` bytes apart,
// from src.  By rows (ns = 90) a tree's nodes are one run (all the block's
// trees one run when they are adjacent) and node (w, i) of the block's
// tree w lands at (w*m + i)*90; by columns (ts = 90) leaf i of the block's
// trees is one run -- n adjacent columns of a grid row -- and node (w, i)
// lands at (i*n + w)*90.
struct NmtTile {
  const uint8_t* src;
  uint64_t stride;
  uint64_t t0;
  uint32_t runs, len, n;
  bool cols;
};

CTT_HD NmtTile nmt_tile(const NmtReduceArgs& a, uint32_t bx, uint32_t g) {
  const uint32_t set = bx >= a.blocks0 ? 1u : 0u;
  const uint64_t u = uint64_t(set ? bx - a.blocks0 : bx) * a.per_block;
  const uint64_t left = (set ? a.tpb - a.split : a.split) - u;
  const uint32_t m = 1u << a.lg_m;
  const uint64_t ts = set ? a.ts1 : a.ts0, ns = set ? a.ns1 : a.ns0;
  NmtTile t;
  t.n = static_cast<uint32_t>(left < a.per_block ? left : a.per_block);
  t.src = a.in + g * a.bs + u * ts;
  t.t0 = uint64_t(g) * a.tpb + (set ? a.split : 0u) + u;
  t.cols = ns != kDigest;
  if (t.cols) {
    t.runs = m;
    t.len = t.n * kDigest;
    t.stride = ns;
  } else if (t.n == 1 || ts == uint64_t(m) * kDigest) {
    t.runs = 1;
    t.len = t.n * m * kDigest;
    t.stride = 0;
  } else {
    t.runs = t.n;
    t.len = m * kDigest;
    t.stride = ts;
  }
  return t;
}

// Stage the tile's level 0 into `a_buf` (16-byte aligned): one run by all
// threads, several runs a warp each, in the widest unit their addresses,
// stride and length allow (16 bytes for the grid rows at k >= 4 and for 8
// adjacent columns or more; 8 bytes for 4 columns at k = 64, 4 bytes for
// 2 columns at k = 128).
CTT_HD void nmt_stage(const NmtTile& t, uint8_t* a_buf, uint32_t tid, uint32_t nthreads) {
  if (t.runs == 1) {
    copy_bytes(a_buf, t.src, t.len, copy_unit(reinterpret_cast<uintptr_t>(t.src) | t.len), tid,
               nthreads);
    return;
  }
  const uint32_t unit = copy_unit(reinterpret_cast<uintptr_t>(t.src) | t.stride | t.len);
  for (uint32_t r = tid / 32u; r < t.runs; r += nthreads / 32u)
    copy_bytes(a_buf + r * t.len, t.src + r * t.stride, t.len, unit, tid % 32u, 32u);
}

// Big-endian words of a 2-byte-aligned node's bytes from `first` on: word
// i is bytes first + 4i .. first + 4i + 3, one PRMT of two aligned 4-byte
// loads at a fixed base (neighbouring words share a load).  Word i reads up
// to 8 bytes from the base, which lies at most 3 bytes before the node's
// byte `first`.
struct NodeWords {
  const uint8_t* base;
  uint32_t sel;
  CTT_HD NodeWords(const uint8_t* node, uint32_t first) {
    const uint32_t o = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(node + first) & 3u);
    base = node + first - o;
    sel = (o << 12) | ((o + 1u) << 8) | ((o + 2u) << 4) | (o + 3u);
  }
  CTT_HD uint32_t operator()(uint32_t i) const {
    return prmt(ld32(base + 4 * i), ld32(base + 4 * i + 4), sel);
  }
};

// The parent of children l and r (90 bytes each, 2-byte aligned, in shared
// memory on the card, with at least 4 readable bytes after r) into o: the
// message `0x01 || l || r` (181 bytes, three blocks) is read word by word
// where it lies, the IgnoreMaxNamespace test is word compares on the
// message words that hold r.min, and the node goes out in 2-byte stores.
CTT_HD void nmt_node(const uint8_t* l, const uint8_t* r, uint8_t* o) {
  const NodeWords lw(l, 3), rw(r, 1);  // message words 1.. (l[4q-1..]) and 23.. (r[4q-91..])
  uint32_t st[8];
  sha256_init(st);
  bool r_parity = false;
#pragma unroll 1
  for (uint32_t blk = 0; blk < 3; ++blk) {
    uint32_t w[16];
    if (blk == 0) {  // message bytes 0..63: 0x01, l[0..63)
      w[0] = 0x01000000u | prmt(ld16(l), ld16(l + 2), 0x7014u);
#pragma unroll
      for (uint32_t i = 1; i < 16; ++i) w[i] = lw(i - 1);
    } else if (blk == 1) {  // 64..127: l[63..90), r[0..37)
#pragma unroll
      for (uint32_t i = 0; i < 6; ++i) w[i] = lw(15 + i);
      w[6] = (lw(21) & 0xFFFFFF00u) | r[0];
#pragma unroll
      for (uint32_t i = 7; i < 16; ++i) w[i] = rw(i - 7);
      // r.min = r[0..29) = the low byte of word 22 and words 23..29
      uint32_t all = w[6] | 0xFFFFFF00u;
#pragma unroll
      for (uint32_t i = 7; i < 14; ++i) all &= w[i];
      r_parity = all == 0xFFFFFFFFu;
    } else {  // 128..191: r[37..90), 0x80, zeros, the bit length 1448
#pragma unroll
      for (uint32_t i = 0; i < 13; ++i) w[i] = rw(9 + i);
      w[13] = (uint32_t(r[89]) << 24) | 0x00800000u;
      w[14] = 0u;
      w[15] = (1u + 2u * kDigest) * 8u;
    }
    sha256_compress(st, w);
  }
  const uint8_t* mx = r_parity ? l : r;
#pragma unroll
  for (uint32_t q = 0; q < 14; ++q) st16(o + 2 * q, ld16(l + 2 * q));
  st16(o + 28, prmt(ld16(l + 28), ld16(mx + 28), 0x0050u));  // l.min[28], max[0]
#pragma unroll
  for (uint32_t q = 15; q < 29; ++q) st16(o + 2 * q, ld16(mx + 2 * q));
#pragma unroll
  for (uint32_t i = 0; i < 8; ++i) {  // the hash, big-endian words
    st16(o + 2 * kNs + 4 * i, prmt(st[i], 0u, 0x0023u));
    st16(o + 2 * kNs + 4 * i + 2, prmt(st[i], 0u, 0x0001u));
  }
}

// Thread p's parent at level j >= 1 of the tile's trees, read from level
// j - 1 in `in` and written to level j in `out` (node (w, i) at
// (w*(m >> j) + i)*90, the order of the packed output).
CTT_HD void nmt_level_step(const NmtReduceArgs& a, const NmtTile& t, uint32_t j,
                           const uint8_t* in, uint8_t* out, uint32_t p) {
  const uint32_t lg_mo = a.lg_m - j;
  if (p >= (t.n << lg_mo)) return;
  const uint8_t* l;
  const uint8_t* r;
  if (j == 1 && t.cols) {
    const uint32_t w = p >> lg_mo, i = p & ((1u << lg_mo) - 1u);
    l = in + (2u * i * t.n + w) * kDigest;
    r = l + t.n * kDigest;
  } else {
    l = in + 2u * p * kDigest;
    r = l + kDigest;
  }
  nmt_node(l, r, out + p * kDigest);
}

// Thread tid's share of writing level j (now in `buf`) to its place in the
// packed output: the tile's trees are adjacent there, so one run.
CTT_HD void nmt_store_level(const NmtReduceArgs& a, const NmtTile& t, uint32_t j,
                            const uint8_t* buf, uint32_t tid, uint32_t nthreads) {
  const uint32_t m = 1u << a.lg_m, mo = m >> j;
  uint8_t* dst = a.out + (a.ntrees * (m - (m >> (j - 1))) + t.t0 * mo) * kDigest;
  const uint32_t n = t.n * mo * kDigest;
  copy_bytes(dst, buf, n, copy_unit(reinterpret_cast<uintptr_t>(dst) | n), tid, nthreads);
}

// --- K2: leaf digests ------------------------------------------------------

// A block hashes 64 consecutive cells, one a thread.  The shares are staged
// at a row stride of 516 bytes (129 words, odd) so the 64 threads reading
// word i of their own shares hit distinct banks.
constexpr uint32_t kLeafCells = 64;
constexpr uint32_t kLeafRow = kShare + 4;
constexpr uint32_t kLeafSmemBytes = kLeafCells * kLeafRow;  // 33,024
constexpr uint32_t kLeafBatch = 8;  // shares a warp has in flight while staging

CTT_HD void load16(const uint8_t* p, uint32_t v[4]) {
#ifdef __CUDA_ARCH__
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
#else
  for (int i = 0; i < 4; ++i) v[i] = ld32(p + 4 * i);
#endif
}

// Thread tid stages the shares of cells cell0 .. cell0 + n - 1 (eds 16-byte
// aligned): warp w takes cells w, w + nwarps, ... a batch at a time; lane q
// loads bytes 16q..16q+15 of a share (a warp reads one whole 512-byte share
// a load) and stores them as 4 words, their order rotated by q / 8, so the
// warp's 32 stores of a step fall on 32 banks.
CTT_HD void nmt_leaf_stage(const uint8_t* eds, uint64_t cell0, uint32_t n, uint8_t* rows,
                           uint32_t tid, uint32_t nthreads) {
  const uint32_t lane = tid & 31u, rot = lane >> 3, step = nthreads >> 5;
  for (uint32_t c0 = tid >> 5; c0 < n; c0 += kLeafBatch * step) {
    uint32_t v[kLeafBatch][4];
#pragma unroll
    for (uint32_t b = 0; b < kLeafBatch; ++b) {
      const uint32_t c = c0 + b * step;
      if (c < n) load16(eds + (cell0 + c) * kShare + 16u * lane, v[b]);
    }
#pragma unroll
    for (uint32_t b = 0; b < kLeafBatch; ++b) {
      const uint32_t c = c0 + b * step;
      if (c >= n) continue;
      uint8_t* dst = rows + c * kLeafRow + 16u * lane;
#pragma unroll
      for (uint32_t i = 0; i < 4; ++i) {
        const uint32_t e = (i + rot) & 3u;
        st32(dst + 4 * e, e == 0 ? v[b][0] : e == 1 ? v[b][1] : e == 2 ? v[b][2] : v[b][3]);
      }
    }
  }
}

// The Q0 rule at the cell's EDS coordinates: cell = (window, row, column)
// of batch x n_rows x n2, the window starting at EDS row row0.
CTT_HD bool nmt_leaf_q0(uint32_t cell, uint32_t lg_n2, uint32_t row0, uint32_t n_rows) {
  const uint32_t n2 = 1u << lg_n2, k = n2 >> 1;
  const uint32_t c = cell & (n2 - 1u), r = row0 + (cell >> lg_n2) % n_rows;
  return r < k && c < k;
}

// K2's row-set mode: the leaf digests of n_trees row trees of one EDS, tree
// i the EDS row ids[i], into out uint8[n_trees, n2, 90].  Tree i's shares
// are source row row_i of src uint8[rows, n2, 512], row_i = ids[i] for an
// EDS read in place or i for rows already gathered into a block.  The ids
// travel by value in the launch's parameters: an EDS has at most 256 rows
// (k <= 128).
constexpr uint32_t kRowSetLgMax = 8;
constexpr uint32_t kRowSetMax = 1u << kRowSetLgMax;

struct NmtRowSet {
  const uint8_t* src;
  uint8_t* out;
  uint32_t lg_n2;    // log2 of the EDS width 2k
  uint32_t cells;    // n_trees * n2
  uint32_t in_place; // 1: tree i reads source row ids[i]; 0: row i
  uint16_t ids[kRowSetMax];
};

// Fill `a` for one launch; false for what the kernel does not take: 2k not
// a power of two in 2..256, no tree or more than 2k, an id at or past 2k,
// a source off a 16-byte boundary (the shares are loaded 16 bytes at a
// time), or an odd output address.
CTT_HD bool nmt_rows_setup(NmtRowSet* a, const uint8_t* src, uint8_t* out, uint32_t n2,
                           uint32_t n_trees, const uint16_t* ids, uint32_t in_place) {
  const uint32_t lg_n2 = log2_exact(n2);
  if (lg_n2 < 1 || lg_n2 > kRowSetLgMax || n_trees < 1 || n_trees > n2 ||
      (reinterpret_cast<uintptr_t>(src) & 15u) || (reinterpret_cast<uintptr_t>(out) & 1u))
    return false;
  for (uint32_t i = 0; i < n_trees; ++i) {
    if (ids[i] >= n2) return false;
    a->ids[i] = ids[i];
  }
  a->src = src;
  a->out = out;
  a->lg_n2 = lg_n2;
  a->cells = n_trees << lg_n2;
  a->in_place = in_place ? 1u : 0u;
  return true;
}

// Thread tid stages cells cell0 .. cell0 + n - 1 of the row set (cell = tree
// * n2 + column) as nmt_leaf_stage does: a block's 64 cells are one run of
// one source row at k >= 32, and 64 / 2k whole rows below.
CTT_HD void nmt_rows_stage(const NmtRowSet& a, uint32_t cell0, uint32_t n, uint8_t* rows,
                           uint32_t tid, uint32_t nthreads) {
  const uint32_t n2 = 1u << a.lg_n2;
  for (uint32_t s = 0; s < n;) {
    const uint32_t tree = (cell0 + s) >> a.lg_n2, c = (cell0 + s) & (n2 - 1u);
    const uint32_t len = n - s < n2 - c ? n - s : n2 - c;
    const uint64_t row = a.in_place ? a.ids[tree] : tree;
    nmt_leaf_stage(a.src + (row << a.lg_n2) * kShare, c, len, rows + s * kLeafRow, tid, nthreads);
    s += len;
  }
}

// The Q0 rule at the cell's EDS coordinates: row ids[tree], its column.
CTT_HD bool nmt_rows_q0(const NmtRowSet& a, uint32_t cell) {
  const uint32_t k = 1u << (a.lg_n2 - 1u);
  return a.ids[cell >> a.lg_n2] < k && (cell & ((k << 1) - 1u)) < k;
}

// A thread's hash: its state, the share's first 8 little-endian words (the
// digest's namespace) and the Q0 rule, kept across the barrier before the
// digests overwrite the staged shares.
struct LeafHash {
  uint32_t st[8];
  uint32_t pre[8];
  bool q0;
};

// sha256(0x00 || prefix || share) of the share staged at `row` (4-byte
// aligned, word i = share bytes 4i..4i+3), prefix = share[0..29) in Q0 and
// 29 x 0xFF elsewhere: 542 bytes, 9 blocks.  Message word q >= 8 is share
// bytes 4q-30 .. 4q-27, one PRMT of two staged words.
CTT_HD void nmt_leaf_hash(const uint8_t* row, bool q0, LeafHash* h) {
  h->q0 = q0;
  const uint32_t* P = h->pre;
#pragma unroll
  for (uint32_t i = 0; i < 8; ++i) h->pre[i] = ld32(row + 4 * i);
  sha256_init(h->st);
#pragma unroll 1
  for (uint32_t blk = 0; blk < 9; ++blk) {
    uint32_t w[16];
    if (blk == 0) {  // 0x00, the prefix, share[0..34)
      w[0] = q0 ? prmt(P[0], 0u, 0x4012u) : 0x00FFFFFFu;
#pragma unroll
      for (int i = 1; i < 7; ++i) w[i] = q0 ? prmt(P[i - 1], P[i], 0x3456u) : 0xFFFFFFFFu;
      w[7] = q0 ? prmt(prmt(P[6], P[7], 0x0034u), P[0], 0x1045u) : prmt(P[0], ~0u, 0x4401u);
#pragma unroll
      for (int i = 8; i < 16; ++i) w[i] = prmt(ld32(row + 4 * (i - 8)), ld32(row + 4 * (i - 7)), 0x2345u);
    } else if (blk < 8) {
      const uint8_t* s = row + 64u * blk - 32u;  // staged word 16 blk - 8
#pragma unroll
      for (int i = 0; i < 16; ++i) w[i] = prmt(ld32(s + 4 * i), ld32(s + 4 * i + 4), 0x2345u);
    } else {  // share[482..512), 0x80, zeros, the bit length 4336
      const uint8_t* s = row + 480u;
#pragma unroll
      for (int i = 0; i < 7; ++i) w[i] = prmt(ld32(s + 4 * i), ld32(s + 4 * i + 4), 0x2345u);
      w[7] = prmt(ld32(s + 28), 0x80u, 0x2345u);
#pragma unroll
      for (int i = 8; i < 15; ++i) w[i] = 0u;
      w[15] = (1u + kNs + kShare) * 8u;
    }
    sha256_compress(h->st, w);
  }
}

// The 90-byte leaf digest `prefix || prefix || hash` at o (2-byte aligned),
// in 2-byte stores.
CTT_HD void nmt_leaf_digest(const LeafHash& h, uint8_t* o) {
  const uint32_t* P = h.pre;
  const bool q0 = h.q0;
#pragma unroll
  for (uint32_t q = 0; q < 14; ++q) st16(o + 2 * q, q0 ? P[q >> 1] >> (16u * (q & 1u)) : 0xFFFFu);
  st16(o + 28, q0 ? prmt(P[7], P[0], 0x0040u) : 0xFFFFu);  // prefix[28], prefix[0]
#pragma unroll
  for (uint32_t q = 15; q < 29; ++q) {  // prefix[2q-29], prefix[2q-28]
    const uint32_t b = 2u * q - 29u;
    st16(o + 2 * q, q0 ? prmt(P[b >> 2], P[(b >> 2) + 1], (((b & 3u) + 1u) << 4) | (b & 3u)) : 0xFFFFu);
  }
#pragma unroll
  for (uint32_t i = 0; i < 8; ++i) {
    st16(o + 2 * kNs + 4 * i, prmt(h.st[i], 0u, 0x0023u));
    st16(o + 2 * kNs + 4 * i + 2, prmt(h.st[i], 0u, 0x0001u));
  }
}

// Thread tid's share of writing the block's n digests (at the start of
// `digests`) to out[cell0 ..]: 5,760 contiguous bytes for a whole block,
// 16-byte aligned when out is.
CTT_HD void nmt_leaf_store(uint8_t* out, uint64_t cell0, uint32_t n, const uint8_t* digests,
                           uint32_t tid, uint32_t nthreads) {
  uint8_t* dst = out + cell0 * kDigest;
  const uint32_t nb = n * kDigest;
  copy_bytes(dst, digests, nb, copy_unit(reinterpret_cast<uintptr_t>(dst) | nb), tid, nthreads);
}

// --- K4: the RFC-6962 tree, leaves to root, in one block --------------------

// One block builds one tree of n (a power of two, at most 1024) leaves.
// The nodes live in shared memory as 8 word planes: word i of the node in
// packed row x (the n leaf hashes first, then n/2, ..., the root last: row
// 2n - 2m + p is node p of the level of m nodes) is planes[i * plane + x],
// the big-endian state word.  A parent's thread reads its two children as
// one 8-byte load a plane (neighbouring threads, neighbouring 8 bytes), a
// node's thread writes its 8 words to 8 planes, and no level overwrites
// another, so a level goes out to device memory while the next computes.
constexpr uint32_t kRfcMaxLeaves = 1024;
constexpr uint32_t kRfcMaxThreads = 512;
constexpr uint32_t kRfcStageBudget = 65536;  // staged leaf bytes a pass
constexpr uint32_t kRfcStagePad = 16;        // readable bytes before the staged leaves
constexpr uint32_t kRfcWarpNodes = 32;       // levels of at most this many nodes: warp 0 alone
// the planes at their largest, the staging buffer and its slack
constexpr uint32_t kRfcMaxSmem =
    8 * (2 * kRfcMaxLeaves + 4) * 4 + kRfcStagePad + kRfcStageBudget + 32;

struct RfcArgs {
  const uint8_t* in;   // leaves uint8[batch, n, L], or level-0 hashes uint8[batch, n, 32]
  uint8_t* out;        // uint8[batch, 2n - 1, 32]
  uint32_t n, L;
  uint32_t leaf_pass;  // 1: level 0 is sha256(0x00 || leaf); 0: the inputs are level 0
  uint32_t threads;    // a block's: n clamped to 32..512
  uint32_t tile;       // leaves staged a pass
  uint32_t plane;      // words between two planes: 2n + 4
  uint32_t stage_off;  // byte offset of the staged leaves (past their front pad)
  uint32_t smem;       // dynamic shared memory bytes
};

// Fill `a`; returns the threads of a block, or 0 for what the kernel does
// not take: n not a power of two in 1..1024, no trees, L = 0 (or not 32
// without the leaf pass), a leaf longer than the staging buffer, a tree
// whose leaves start at an odd address, an output off a 16-byte boundary.
CTT_HD uint32_t rfc6962_setup(RfcArgs* a, const uint8_t* in, uint8_t* out, uint64_t batch,
                              uint32_t n, uint32_t L, uint32_t leaf_pass) {
  if (log2_exact(n) > 10 || batch == 0 || batch > 0x7FFFFFFFull || L == 0 ||
      L > kRfcStageBudget || (!leaf_pass && L != 32))
    return 0;
  if (((reinterpret_cast<uintptr_t>(in) | (uint64_t(n) * L)) & 1u) ||
      (reinterpret_cast<uintptr_t>(out) & 15u))
    return 0;
  a->in = in;
  a->out = out;
  a->n = n;
  a->L = L;
  a->leaf_pass = leaf_pass ? 1u : 0u;
  a->threads = n < 32 ? 32 : (n > kRfcMaxThreads ? kRfcMaxThreads : n);
  const uint32_t fit = kRfcStageBudget / L;
  a->tile = fit < a->threads ? fit : a->threads;
  a->plane = 2 * n + 4;
  a->stage_off = 8 * a->plane * 4 + kRfcStagePad;  // 16-byte aligned: plane is even
  a->smem = a->stage_off + (a->tile * L + 32u + 15u) / 16u * 16u;
  return a->threads;
}

// The leaves of tree b's pass from leaf t0: `cnt` leaves, one run of
// cnt * L bytes at `src`, staged from the 16-byte boundary `skew` bytes
// below it, so that every load is 16 bytes whatever the run's alignment.
struct RfcTile {
  const uint8_t* src;
  uint32_t t0, cnt, len, skew, chunks;
};

CTT_HD RfcTile rfc6962_tile(const RfcArgs& a, uint64_t b, uint32_t t0) {
  RfcTile t;
  t.src = a.in + (b * a.n + t0) * a.L;
  t.t0 = t0;
  t.cnt = a.n - t0 < a.tile ? a.n - t0 : a.tile;
  t.len = t.cnt * a.L;
  t.skew = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(t.src) & 15u);
  t.chunks = (t.skew + t.len + 15u) / 16u;
  return t;
}

// Thread tid of nthreads stages its 16-byte chunks: chunk c of the run's
// aligned cover to stage + 16c, so leaf i starts at stage + skew + i*L.
// The cover's bytes outside the run lie in a 16-byte granule that holds a
// byte of the tensor (inside its allocation) and are never message bytes;
// the host copies only the run's own bytes.
CTT_HD void rfc6962_stage(const RfcTile& t, uint8_t* stage, uint32_t tid, uint32_t nthreads) {
  const uint8_t* cover = t.src - t.skew;
  for (uint32_t c = tid; c < t.chunks; c += nthreads) {
#ifdef __CUDA_ARCH__
    reinterpret_cast<uint4*>(stage)[c] = reinterpret_cast<const uint4*>(cover)[c];
#else
    for (uint32_t p = 16 * c; p < 16 * c + 16; ++p)
      if (p >= t.skew && p < t.skew + t.len) stage[p] = cover[p];
#endif
  }
}

// `0x00 || leaf` (an RFC-6962 leaf) from a staged leaf, with readable bytes
// before and after it: message word q is leaf bytes 4q-1 .. 4q+2, one PRMT
// of two aligned shared words, the byte before the leaf masked to 0x00.
struct StagedLeafSrc {
  NodeWords w;
  const uint8_t* leaf;
  CTT_HD StagedLeafSrc(const uint8_t* l) : w(l - 1, 0), leaf(l) {}
  CTT_HD uint32_t byte(uint32_t p) const { return p ? leaf[p - 1] : 0u; }
  CTT_HD uint32_t word(uint32_t p) const { return p ? w(p / 4) : w(0) & 0x00FFFFFFu; }
};

// Thread tid's level-0 node of the pass: sha256(0x00 || leaf) (the leaf
// pass) or the given hash's words, into the planes at row t0 + tid.
CTT_HD void rfc6962_leaf(const RfcArgs& a, const RfcTile& t, const uint8_t* stage,
                         uint32_t* planes, uint32_t tid) {
  if (tid >= t.cnt) return;
  const uint8_t* leaf = stage + t.skew + tid * a.L;
  uint32_t st[8];
  if (!a.leaf_pass) {
    const NodeWords w(leaf, 0);
#pragma unroll
    for (uint32_t i = 0; i < 8; ++i) st[i] = w(i);
  } else {
    sha256_message(StagedLeafSrc(leaf), a.L + 1u, st);
  }
#pragma unroll
  for (uint32_t i = 0; i < 8; ++i) planes[i * a.plane + t.t0 + tid] = st[i];
}

// One level step of the tree, thread tid of nthreads, on the level of m
// nodes (rows 2n - 2m ..): threads below m/2 compute the parents (rows
// 2n - m ..), and the others write level m out -- or every thread does both
// when none is free (1,024 leaves) -- as 16-byte stores, neighbouring
// threads on neighbouring 16 bytes, each word byte-swapped to the digest's
// bytes.  Level m is read-only from here on, so the stores need no barrier.
CTT_HD void rfc6962_level_step(const RfcArgs& a, uint32_t* planes, uint8_t* tree, uint32_t m,
                               uint32_t tid, uint32_t nthreads) {
  const uint32_t mo = m >> 1, row = 2 * a.n - 2 * m;
  const uint32_t spare = nthreads > mo ? nthreads - mo : nthreads, first = nthreads - spare;
  if (tid >= first) {
    for (uint32_t c = tid - first; c < 2 * m; c += spare) {
      const uint32_t x = row + (c >> 1), h = 4 * (c & 1u);
      uint32_t v[4];
#pragma unroll
      for (uint32_t e = 0; e < 4; ++e) v[e] = prmt(planes[(h + e) * a.plane + x], 0u, 0x0123u);
      uint8_t* dst = tree + 32u * x + 4u * h;
#ifdef __CUDA_ARCH__
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
#else
      for (uint32_t e = 0; e < 4; ++e) st32(dst + 4 * e, v[e]);
#endif
    }
  }
  if (tid < mo) {
    uint32_t l[8], r[8], st[8];
#pragma unroll
    for (uint32_t i = 0; i < 8; ++i) {
      const uint32_t* pair = planes + i * a.plane + row + 2 * tid;
#ifdef __CUDA_ARCH__
      const uint2 lr = *reinterpret_cast<const uint2*>(pair);
      l[i] = lr.x;
      r[i] = lr.y;
#else
      l[i] = pair[0];
      r[i] = pair[1];
#endif
    }
    sha256_inner65(l, r, st);
#pragma unroll
    for (uint32_t i = 0; i < 8; ++i) planes[i * a.plane + row + m + tid] = st[i];
  }
}

}  // namespace ctt
