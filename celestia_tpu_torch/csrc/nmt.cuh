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
// K3 and K4 (the RFC-6962 tree) keep their nodes in shared memory as
// big-endian word planes: a parent's thread reads its two children as one
// 8-byte load a plane, builds its message by PRMTs in registers and writes
// its words to the planes; every level stays there, so a finished level
// goes out to device memory while the next computes, and warp 0 runs the
// last levels alone (K4's 65-byte inner node is sha256.cuh's
// sha256_inner65).
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

// --- K3: the level reduction -------------------------------------------

// A block reduces a tile of 256, 512 or 1,024 level-0 nodes -- whole trees,
// tile / m of them -- one thread a level-1 parent.  The launch picks the
// smallest tile that holds a tree and gives about one block an SM (its
// trees' leaves over the card's SMs): a k = 128 grid's 512 trees go four a
// block, one block an SM; a k = 64 grid's two a block; a row stack's one.
// Two blocks sharing an SM were measured to run their one-warp last levels
// one after the other; with one block an SM each level's warps spread over
// the SM's four schedulers.  The nodes live in shared memory
// as word planes, as K4's do: word q of the node in row x of a plane set is
// set[q * plane + x], the big-endian bytes 4q .. 4q + 3 of its 90 (word
// 22: bytes 88, 89 and two zero bytes).  Set A holds level 0, set B every
// level above it, level j from row tile - (tile >> (j - 1)) on, so no level
// overwrites another.  Node (w, i) of the block's tree w is row
// w * (m >> j) + i of level j: the order of the packed output.  Level 0 is
// staged as bytes where set B lies, and unpacked into set A before level 1
// is written over the staged bytes.
constexpr uint32_t kNmtLgTree = 9;      // the tallest tree: 512 leaves (an EDS axis has 256)
constexpr uint32_t kNmtLgTileMin = 8;   // the tiles: 2^8 .. 2^10 level-0 nodes
constexpr uint32_t kNmtLgTileMax = 10;
constexpr uint32_t kNmtThreads = 1u << (kNmtLgTileMax - 1);  // the most threads a block
constexpr uint32_t kNmtWords = 23;                           // plane words a node
constexpr uint32_t kNmtPad = 4;  // plane = tile + 4 words: a plane 4 banks from the next
constexpr uint32_t kNmtWarpNodes = 32;   // levels of at most this many parents: one warp
constexpr uint32_t kNmtStageBatch = 12;  // 16-byte loads a thread has in flight while staging
constexpr uint32_t kNmtStageSlack = 16;  // readable bytes after the staged runs
// the largest tile's plane set, and its largest stage: at most 512 runs, each
// staged from an aligned cover at most 30 bytes longer than the run
constexpr uint32_t kNmtMaxSetBytes = kNmtWords * ((1u << kNmtLgTileMax) + kNmtPad) * 4;
constexpr uint32_t kNmtMaxStage = (1u << kNmtLgTileMax) * kDigest + 512u * 30u + kNmtStageSlack;
constexpr uint32_t kNmtMaxSmem = kNmtMaxSetBytes + kNmtMaxStage;  // 202,112

// A tile's plane sets in shared memory.  The kernel builds it from its
// template's tile, so every stride below is a constant there.
struct NmtPlanes {
  uint32_t* base;  // set A; set B follows it
  uint32_t tile, plane;
  CTT_HD uint32_t set_words() const { return kNmtWords * plane; }
  // level j's first row: set A's row 0 for level 0, set B's rows above
  CTT_HD uint32_t* level(uint32_t j) const {
    return j ? base + set_words() + tile - (tile >> (j - 1)) : base;
  }
  // the staged level 0: set B's bytes
  CTT_HD uint8_t* stage() const { return reinterpret_cast<uint8_t*>(base + set_words()); }
};

CTT_HD NmtPlanes nmt_planes(void* smem, uint32_t lg_tile) {
  return NmtPlanes{static_cast<uint32_t*>(smem), 1u << lg_tile, (1u << lg_tile) + kNmtPad};
}

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
  uint32_t lg_tile;       // log2 of a block's level-0 nodes, 8 .. 10
  uint32_t smem;          // dynamic shared memory bytes of a block
};

// How a block's n trees of m leaves lie in the input, staged as `runs` runs
// of `len` bytes, `stride` bytes apart, from src.  By rows (ns = 90) a
// tree's nodes are one run (all the block's trees one run when they are
// adjacent); by columns (ts = 90) leaf i of the block's trees is run i, n
// adjacent columns of a grid row.  Each run is staged from the 16-byte
// word that holds its first byte, rs bytes after the run before it.
struct NmtTile {
  const uint8_t* src;
  uint64_t stride;
  uint64_t t0;  // the block's first tree, counted over the launch
  uint32_t runs, len, n, rs;
  bool cols;
};

CTT_HD void nmt_shape(NmtTile* t, uint32_t m, uint32_t n, uint64_t ts, uint64_t ns) {
  t->n = n;
  t->cols = ns != kDigest;
  if (t->cols) {
    t->runs = m;
    t->len = n * kDigest;
    t->stride = ns;
  } else if (n == 1 || ts == uint64_t(m) * kDigest) {
    t->runs = 1;
    t->len = n * m * kDigest;
    t->stride = 0;
  } else {
    t->runs = n;
    t->len = m * kDigest;
    t->stride = ts;
  }
  t->rs = (t->len + 14u + 15u) / 16u * 16u;  // the widest cover: the run 14 bytes into a word
}

// Fill `a` for one launch on a card of `sms` SMs; returns the blocks of a
// group (the grid's x; the groups, ntrees / tpb, are its y), or 0 for what
// the kernel does not take: m not a power of two in 2..512, n_levels
// outside 1..log2 m, groups that do not divide the trees, odd addresses or
// strides (nodes are staged from 2-byte boundaries), or trees of fewer than
// 512 leaves whose nodes interleave neither by rows (ns = 90) nor by
// columns (ts = 90) -- several such trees cannot share a block.
CTT_HD uint32_t nmt_reduce_setup(NmtReduceArgs* a, const uint8_t* in, uint8_t* out,
                                 uint64_t ntrees, uint32_t m, uint32_t n_levels, uint64_t split,
                                 uint64_t ts0, uint64_t ns0, uint64_t ts1, uint64_t ns1,
                                 uint64_t tpb, uint64_t bs, uint32_t sms) {
  const uint32_t lg_m = log2_exact(m);
  if (lg_m == 0 || lg_m > kNmtLgTree || tpb == 0 || ntrees == 0 || ntrees % tpb ||
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
  a->n_levels = n_levels;
  // the tile: one tree at least, the launch's leaves over the SMs at most
  // (up to 1,024); one tree a block where a set's trees interleave neither way
  const uint64_t per_sm = (ntrees * m + (sms ? sms : 1u) - 1u) / (sms ? sms : 1u);
  a->lg_tile = lg_m > kNmtLgTileMin ? lg_m : kNmtLgTileMin;
  while (a->lg_tile < kNmtLgTileMax && (uint64_t(1) << a->lg_tile) < per_sm) ++a->lg_tile;
  for (uint32_t set = 0; set < 2; ++set) {
    const uint64_t trees = set ? tpb - split : split;
    const uint64_t ts = set ? ts1 : ts0, ns = set ? ns1 : ns0;
    if (trees && ns != kDigest && ts != kDigest) {
      if (lg_m < kNmtLgTree) return 0;
      a->lg_tile = lg_m;
    }
  }
  a->per_block = 1u << (a->lg_tile - lg_m);
  uint64_t blocks[2];
  uint32_t stage = 0;
  for (uint32_t set = 0; set < 2; ++set) {
    const uint64_t trees = set ? tpb - split : split;
    const uint64_t ts = set ? ts1 : ts0, ns = set ? ns1 : ns0;
    blocks[set] = (trees + a->per_block - 1) / a->per_block;
    if (trees == 0) continue;
    NmtTile t;
    nmt_shape(&t, m, static_cast<uint32_t>(trees < a->per_block ? trees : a->per_block), ts, ns);
    stage = t.runs * t.rs > stage ? t.runs * t.rs : stage;
  }
  if (blocks[0] + blocks[1] > 0x7FFFFFFFull) return 0;
  a->blocks0 = static_cast<uint32_t>(blocks[0]);
  stage += kNmtStageSlack;
  const uint32_t set = kNmtWords * ((1u << a->lg_tile) + kNmtPad) * 4;
  a->smem = set + (stage > set ? stage : set);
  return static_cast<uint32_t>(blocks[0] + blocks[1]);
}

// What block (bx, group g) reduces.
CTT_HD NmtTile nmt_tile(const NmtReduceArgs& a, uint32_t bx, uint32_t g) {
  const uint32_t set = bx >= a.blocks0 ? 1u : 0u;
  const uint64_t u = uint64_t(set ? bx - a.blocks0 : bx) * a.per_block;
  const uint64_t left = (set ? a.tpb - a.split : a.split) - u;
  const uint64_t ts = set ? a.ts1 : a.ts0, ns = set ? a.ns1 : a.ns0;
  NmtTile t;
  nmt_shape(&t, 1u << a.lg_m, static_cast<uint32_t>(left < a.per_block ? left : a.per_block), ts,
            ns);
  t.src = a.in + g * a.bs + u * ts;
  t.t0 = uint64_t(g) * a.tpb + (set ? a.split : 0u) + u;
  return t;
}

// Bytes from run r's first byte back to the 16-byte boundary below it.
CTT_HD uint32_t nmt_skew(const NmtTile& t, uint32_t r) {
  return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(t.src + r * t.stride) & 15u);
}

// Thread tid of nthreads stages level 0: the 16-byte words of each run's
// aligned cover, word c of run r to stage + r*rs + 16c (the run's byte b at
// stage + r*rs + skew + b), kNmtStageBatch loads in flight before their
// stores; neighbouring threads take neighbouring words, so a warp reads 512
// contiguous bytes of a run at a time.  The cover's bytes outside the run
// lie in a 16-byte granule that holds a byte of the tensor (inside its
// allocation) and are never read as node bytes; the host copies only the
// run's own bytes.
CTT_HD void nmt_stage(const NmtTile& t, uint8_t* stage, uint32_t tid, uint32_t nthreads) {
  const uint32_t cpr = t.rs / 16u, total = t.runs * cpr;
  for (uint32_t c0 = tid; c0 < total; c0 += kNmtStageBatch * nthreads) {
    Word16 v[kNmtStageBatch];
    uint32_t at[kNmtStageBatch];  // the word's place in the stage, or ~0u for none
#pragma unroll
    for (uint32_t b = 0; b < kNmtStageBatch; ++b) {
      const uint32_t idx = c0 + b * nthreads;
      const uint32_t r = t.runs == 1 ? 0u : idx / cpr, c = idx - r * cpr;
      const uint32_t skew = nmt_skew(t, r);
      at[b] = ~0u;
      if (idx >= total || 16u * c >= skew + t.len) continue;
      at[b] = r * t.rs + 16u * c;
      const uint8_t* run = t.src + uint64_t(r) * t.stride;
#ifdef __CUDA_ARCH__
      v[b] = reinterpret_cast<const uint4*>(run - skew)[c];
#else
      uint8_t bytes[16] = {};
      for (uint32_t p = 16u * c; p < 16u * c + 16u; ++p)
        if (p >= skew && p < skew + t.len) bytes[p - 16u * c] = run[p - skew];
      memcpy(&v[b], bytes, 16);
#endif
    }
#pragma unroll
    for (uint32_t b = 0; b < kNmtStageBatch; ++b)
      if (at[b] != ~0u) *reinterpret_cast<Word16*>(stage + at[b]) = v[b];
  }
}

// Thread tid of nthreads unpacks its level-0 nodes from the stage into set
// A: node (w, i) -- by rows part of run w, or of run 0 from w*m*90 on; by
// columns node w of run i -- to row w*m + i, its 23 words one PRMT of two
// aligned stage words each.  Thread tid takes the words from word tid % 23
// on, round: the staged column runs of a warp's nodes often lie a multiple
// of 128 bytes apart, and a word read by all its lanes at once would fall
// in one bank 32 times.
CTT_HD void nmt_unpack(const NmtReduceArgs& a, const NmtTile& t, const NmtPlanes& p,
                       uint32_t tid, uint32_t nthreads) {
  const uint8_t* stage = p.stage();
  const uint32_t lg_m = a.lg_m, nodes = t.n << lg_m;
  for (uint32_t x = tid; x < nodes; x += nthreads) {
    const uint32_t w = x >> lg_m, i = x & ((1u << lg_m) - 1u);
    const uint32_t r = t.cols ? i : (t.runs == 1 ? 0u : w);
    const uint32_t node = t.cols ? w : (t.runs == 1 ? x : i);
    const NodeWords nw(stage + r * t.rs + nmt_skew(t, r), node * kDigest);
    uint32_t q = tid % kNmtWords, lo = ld32(nw.base + 4u * q);
    for (uint32_t k = 0; k < kNmtWords; ++k) {  // word q is stage words q and q + 1
      const uint32_t hi = ld32(nw.base + 4u * q + 4u), v = prmt(lo, hi, nw.sel);
      p.base[q * p.plane + x] = q == kNmtWords - 1 ? v & 0xFFFF0000u : v;
      q = q == kNmtWords - 1 ? 0u : q + 1u;
      lo = q ? hi : ld32(nw.base);
    }
  }
}

CTT_HD uint32_t nmt_parents(const NmtReduceArgs& a, const NmtTile& t, uint32_t j) {
  return t.n << (a.lg_m - j);
}

// The first level warp 0 computes alone (at most kNmtWarpNodes parents),
// or n_levels + 1 when every level has more.
CTT_HD uint32_t nmt_tail(const NmtReduceArgs& a, const NmtTile& t) {
  uint32_t j = 1;
  while (j <= a.n_levels && nmt_parents(a, t, j) > kNmtWarpNodes) ++j;
  return j;
}

// The parent of the nodes at `in` and in + 1 (two neighbouring rows of a
// plane set) into row `out`.  Each plane's pair of children is one 8-byte
// load, made just before the block that needs it; the message `0x01 || l
// || r` (181 bytes, three blocks) is one PRMT of two neighbouring words a
// message word (the 0x01 shifts l by a byte, l's 90 bytes shift r by 91),
// the IgnoreMaxNamespace test is word compares on r.min's words, and the
// parent's words are l.min's, the chosen max's (both reread after the
// hash) and the hash shifted by two bytes.
CTT_HD void nmt_node(const uint32_t* in, uint32_t* out, uint32_t plane) {
  uint32_t L[kNmtWords], R[kNmtWords];
  uint32_t st[8];
  sha256_init(st);
  bool r_parity = false;
#pragma unroll 1
  for (uint32_t blk = 0; blk < 3; ++blk) {
    uint32_t w[16];
    if (blk == 0) {  // message bytes 0..63: 0x01, l[0..63)
#pragma unroll
      for (uint32_t q = 0; q < 16; ++q) {
#ifdef __CUDA_ARCH__
        const uint2 lr = *reinterpret_cast<const uint2*>(in + q * plane);
        L[q] = lr.x;
        R[q] = lr.y;
#else
        L[q] = in[q * plane];
        R[q] = in[q * plane + 1];
#endif
      }
      w[0] = prmt(L[0], 0x01u, 0x4321u);  // (prev << 24) | (cur >> 8)
#pragma unroll
      for (uint32_t q = 1; q < 16; ++q) w[q] = prmt(L[q], L[q - 1], 0x4321u);
      // r.min = r[0..29): words 0..6 and the top byte of word 7
      uint32_t all = R[7] | 0x00FFFFFFu;
#pragma unroll
      for (uint32_t q = 0; q < 7; ++q) all &= R[q];
      r_parity = all == 0xFFFFFFFFu;
    } else if (blk == 1) {  // 64..127: l[63..90), r[0..37)
#pragma unroll
      for (uint32_t q = 16; q < kNmtWords; ++q) {
#ifdef __CUDA_ARCH__
        const uint2 lr = *reinterpret_cast<const uint2*>(in + q * plane);
        L[q] = lr.x;
        R[q] = lr.y;
#else
        L[q] = in[q * plane];
        R[q] = in[q * plane + 1];
#endif
      }
#pragma unroll
      for (uint32_t q = 16; q < 22; ++q) w[q - 16] = prmt(L[q], L[q - 1], 0x4321u);
      w[6] = prmt(prmt(L[22], L[21], 0x4321u), R[0], 0x3217u);  // l[87..90), r[0]
#pragma unroll
      for (uint32_t s = 0; s < 9; ++s) w[7 + s] = prmt(R[s + 1], R[s], 0x6543u);  // (cur << 8) | (next >> 24)
    } else {  // 128..191: r[37..90), 0x80, zeros, the bit length 1448
#pragma unroll
      for (uint32_t s = 9; s < 22; ++s) w[s - 9] = prmt(R[s + 1], R[s], 0x6543u);
      w[13] = prmt(R[22], 0x00800000u, 0x2644u);  // r[89], 0x80, 0, 0
      w[14] = 0u;
      w[15] = (1u + 2u * kDigest) * 8u;
    }
    sha256_compress(st, w);
  }
  const uint32_t* mx = in + (r_parity ? 0u : 1u);
#pragma unroll
  for (uint32_t q = 0; q < 7; ++q) out[q * plane] = in[q * plane];
  out[7 * plane] = prmt(mx[7 * plane], in[7 * plane], 0x7210u);  // l.min[28], max[0..3)
#pragma unroll
  for (uint32_t q = 8; q < 14; ++q) out[q * plane] = mx[q * plane];
  out[14 * plane] = prmt(st[0], mx[14 * plane], 0x7632u);  // max[27..29), hash[0..2)
#pragma unroll
  for (uint32_t q = 15; q < 22; ++q) out[q * plane] = prmt(st[q - 14], st[q - 15], 0x5432u);
  out[22 * plane] = st[7] << 16;
}

// Little-endian 4 bytes of a level's packed bytes, from its plane rows `lv`:
// node x's bytes q .. q + 3 (q even), or at q = 88 its last two and the
// next node's first two -- one PRMT of two words.
CTT_HD uint32_t nmt_out_word(const uint32_t* lv, uint32_t x, uint32_t q, uint32_t plane) {
  const uint32_t* word = lv + (q >> 2) * plane + x;
  // selects, not branches: a warp's lanes take every case at once
  const uint32_t* next = (q & 2u) ? word + plane : (q == 88u ? lv + x + 1u : word);
  return prmt(word[0], *next, (q & 2u) ? 0x6701u : (q == 88u ? 0x6723u : 0x0123u));
}

// Little-endian 2 bytes from byte o (even) of a level's packed bytes.
CTT_HD uint32_t nmt_out_half(const uint32_t* lv, uint32_t o, uint32_t plane) {
  const uint32_t x = o / kDigest, q = o - x * kDigest;
  return prmt(lv[(q >> 2) * plane + x], 0u, (q & 2u) ? 0x0001u : 0x0023u);
}

// Thread i0 of `step`'s share of writing level j of the tile (its rows of
// set B) to its place in the packed output, where the tile's trees are one
// run of n bytes: the 16-byte words of the run's aligned cover,
// neighbouring threads on neighbouring words, each word's 4 lanes from the
// plane words of at most two nodes; the cover's first and last words,
// which other tiles' bytes may share, as 2-byte stores of the run's own
// bytes.
CTT_HD void nmt_store_level(const NmtReduceArgs& a, const NmtTile& t, const NmtPlanes& p,
                            uint32_t j, uint32_t i0, uint32_t step) {
  const uint32_t m = 1u << a.lg_m, mo = m >> j;
  uint8_t* const dst = a.out + (a.ntrees * (m - (m >> (j - 1))) + t.t0 * mo) * kDigest;
  const uint32_t n = t.n * mo * kDigest;
  const uint32_t skew = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(dst) & 15u);
  const uint32_t words = (skew + n + 15u) / 16u;
  const uint32_t* lv = p.level(j);
  for (uint32_t c = i0; c < words; c += step) {
    const uint32_t c0 = 16u * c;  // the word's first byte, counted from the cover's
    if (c0 >= skew && c0 + 16u <= skew + n) {
      const uint32_t o = c0 - skew;
      uint32_t v[4], x = o / kDigest, q = o - x * kDigest;
#pragma unroll
      for (uint32_t e = 0; e < 4; ++e) {
        v[e] = nmt_out_word(lv, x, q, p.plane);
        q += 4u;
        if (q >= kDigest) {
          q -= kDigest;
          ++x;
        }
      }
#ifdef __CUDA_ARCH__
      *reinterpret_cast<uint4*>(dst + o) = make_uint4(v[0], v[1], v[2], v[3]);
#else
      for (uint32_t e = 0; e < 4; ++e) st32(dst + o + 4u * e, v[e]);
#endif
      continue;
    }
    for (uint32_t b = c0; b < c0 + 16u; b += 2u)
      if (b >= skew && b < skew + n) st16(dst + (b - skew), nmt_out_half(lv, b - skew, p.plane));
  }
}

// Thread tid of nthreads at level j: below the level's parents, its parent
// from level j - 1; the others, when `store` is set, write level j - 1 out
// (level 0 is the input and is never written).
CTT_HD void nmt_level_step(const NmtReduceArgs& a, const NmtTile& t, const NmtPlanes& p,
                           uint32_t j, uint32_t tid, uint32_t nthreads, bool store) {
  const uint32_t parents = nmt_parents(a, t, j);
  if (tid < parents) {
    nmt_node(p.level(j - 1) + 2u * tid, p.level(j) + tid, p.plane);
  } else if (store && j > 1) {
    nmt_store_level(a, t, p, j - 1, tid - parents, nthreads - parents);
  }
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
