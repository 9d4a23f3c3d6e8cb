// SHA-256 compression as per-thread code shared by every hashing kernel
// (K1 sha256.cu, K2/K3 nmt.cu, K4 rfc6962.cu) and by the g++ CPU twin
// (cpu_twin.cpp), which runs these exact bodies on the host in the tests.
//
// Replaces the JAX package's batched SHA-256 (ops/sha256.py:100 `sha256`,
// body `_compress` :59, padding `_padding_bytes` :92).  There the 64 rounds
// run as vector ops over the whole batch; here one thread hashes one
// message with the 8-word state and the 16-word schedule window in
// registers (the loops are fully unrolled, so every index is a constant).
//
// A message is given by a *source*: an object with
//   uint32_t byte(uint32_t p)  -- byte p of the message, p < len
//   uint32_t word(uint32_t p)  -- big-endian bytes p..p+3, all < len
// so a kernel hashes `0x00 || prefix || share` or `0x01 || left || right`
// straight from where the pieces lie, without building the message.  The
// padding (0x80, zeros, 64-bit bit length) is a function of len alone and
// is produced here, never stored.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define CTT_HD __host__ __device__ __forceinline__
#else
#define CTT_HD inline
#endif

namespace ctt {

CTT_HD uint32_t rotr(uint32_t x, uint32_t n) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(x, x, n);
#else
  return (x >> n) | (x << (32u - n));
#endif
}

// Big-endian 32-bit word of the 4 bytes at p, for any alignment of p.
// Reads the aligned word holding p and, when p is not aligned, the next
// one; both hold a byte of p[0..3], so nothing past the last byte's
// aligned word is touched.
CTT_HD uint32_t load_be(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const uint32_t off = static_cast<uint32_t>(addr & 3u);
  const uint32_t* a = reinterpret_cast<const uint32_t*>(addr - off);
  const uint32_t lo = a[0];
  const uint32_t hi = off ? a[1] : 0u;
  // result byte 3 (most significant) = p[0], ..., byte 0 = p[3]
  const uint32_t sel = ((off + 3u)) | ((off + 2u) << 4) | ((off + 1u) << 8) | (off << 12);
  return __byte_perm(lo, hi, sel);
#else
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) |
         uint32_t(p[3]);
#endif
}

// Byte permute of the 8 bytes {y:x} (x bytes 0-3, y bytes 4-7): byte i of
// the result is the byte that nibble i of s names (one PRMT on the card).
CTT_HD uint32_t prmt(uint32_t x, uint32_t y, uint32_t s) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, y, s);
#else
  const uint64_t v = (static_cast<uint64_t>(y) << 32) | x;
  uint32_t r = 0;
  for (uint32_t i = 0; i < 4; ++i) r |= static_cast<uint32_t>((v >> (8u * ((s >> (4u * i)) & 7u))) & 0xFFu) << (8u * i);
  return r;
#endif
}

// log2 of a power of two x >= 1; 64 for any other x.
CTT_HD uint32_t log2_exact(uint64_t x) {
  uint32_t l = 0;
  while ((uint64_t(1) << l) < x) ++l;
  return (uint64_t(1) << l) == x ? l : 64u;
}

// Little-endian loads and stores at an aligned address (4 and 2 bytes).
CTT_HD uint32_t ld32(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const uint32_t*>(p);
#else
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24);
#endif
}

CTT_HD uint32_t ld16(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const uint16_t*>(p);
#else
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8);
#endif
}

CTT_HD void st32(uint8_t* p, uint32_t v) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint32_t*>(p) = v;
#else
  for (int i = 0; i < 4; ++i) p[i] = static_cast<uint8_t>(v >> (8 * i));
#endif
}

// 16 bytes, as one vector load or store on the card (K7b, K9b).
#ifdef __CUDACC__
using Word16 = uint4;
#else
struct alignas(16) Word16 {
  uint32_t x, y, z, w;
};
#endif

CTT_HD void st16(uint8_t* p, uint32_t v) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(v);
#else
  p[0] = static_cast<uint8_t>(v);
  p[1] = static_cast<uint8_t>(v >> 8);
#endif
}

CTT_HD void sha256_init(uint32_t st[8]) {
  st[0] = 0x6A09E667u; st[1] = 0xBB67AE85u; st[2] = 0x3C6EF372u; st[3] = 0xA54FF53Au;
  st[4] = 0x510E527Fu; st[5] = 0x9B05688Cu; st[6] = 0x1F83D9ABu; st[7] = 0x5BE0CD19u;
}

// One compression of the 16-word block w (overwritten: it is the schedule
// window) into state st.
CTT_HD void sha256_compress(uint32_t st[8], uint32_t w[16]) {
  // a local constant table: the rounds are unrolled, so every K[i] folds
  // into an immediate operand (no constant-bank or global declaration
  // that would differ between the host and the device compile)
  const uint32_t K[64] = {
    0x428A2F98u, 0x71374491u, 0xB5C0FBCFu, 0xE9B5DBA5u, 0x3956C25Bu, 0x59F111F1u,
    0x923F82A4u, 0xAB1C5ED5u, 0xD807AA98u, 0x12835B01u, 0x243185BEu, 0x550C7DC3u,
    0x72BE5D74u, 0x80DEB1FEu, 0x9BDC06A7u, 0xC19BF174u, 0xE49B69C1u, 0xEFBE4786u,
    0x0FC19DC6u, 0x240CA1CCu, 0x2DE92C6Fu, 0x4A7484AAu, 0x5CB0A9DCu, 0x76F988DAu,
    0x983E5152u, 0xA831C66Du, 0xB00327C8u, 0xBF597FC7u, 0xC6E00BF3u, 0xD5A79147u,
    0x06CA6351u, 0x14292967u, 0x27B70A85u, 0x2E1B2138u, 0x4D2C6DFCu, 0x53380D13u,
    0x650A7354u, 0x766A0ABBu, 0x81C2C92Eu, 0x92722C85u, 0xA2BFE8A1u, 0xA81A664Bu,
    0xC24B8B70u, 0xC76C51A3u, 0xD192E819u, 0xD6990624u, 0xF40E3585u, 0x106AA070u,
    0x19A4C116u, 0x1E376C08u, 0x2748774Cu, 0x34B0BCB5u, 0x391C0CB3u, 0x4ED8AA4Au,
    0x5B9CCA4Fu, 0x682E6FF3u, 0x748F82EEu, 0x78A5636Fu, 0x84C87814u, 0x8CC70208u,
    0x90BEFFFAu, 0xA4506CEBu, 0xBEF9A3F7u, 0xC67178F2u,
  };
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    uint32_t wi;
    if (i < 16) {
      wi = w[i];
    } else {
      const uint32_t w15 = w[(i - 15) & 15];
      const uint32_t w2 = w[(i - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wi = w[i & 15] + s0 + w[(i - 7) & 15] + s1;  // w[i & 15] is W[i-16]
      w[i & 15] = wi;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + K[i] + wi;
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t2 = S0 + maj;
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// SHA-256 of the len-byte message given by src, into st.
template <class Src>
CTT_HD void sha256_message(const Src& src, uint32_t len, uint32_t st[8]) {
  sha256_init(st);
  const uint32_t nblocks = (len + 9u + 63u) / 64u;
  const uint32_t total = nblocks * 64u;
  const uint64_t bitlen = static_cast<uint64_t>(len) * 8u;
  for (uint32_t blk = 0; blk < nblocks; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t p0 = blk * 64u + 4u * i;
      if (p0 + 3u < len) {
        w[i] = src.word(p0);
      } else {
        uint32_t v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t p = p0 + j;
          uint32_t byte;
          if (p < len) {
            byte = src.byte(p);
          } else if (p == len) {
            byte = 0x80u;
          } else if (p >= total - 8u) {
            byte = static_cast<uint32_t>(bitlen >> (8u * (total - 1u - p))) & 0xFFu;
          } else {
            byte = 0u;
          }
          v = (v << 8) | byte;
        }
        w[i] = v;
      }
    }
    sha256_compress(st, w);
  }
}

// The RFC-6962 inner node sha256(0x01 || l || r) of two digests given as
// their state words (word i = big-endian bytes 4i..4i+3): 65 bytes, two
// blocks.  The 0x01 prefix shifts every message word of block 1 by a byte,
// so each is one PRMT of two neighbouring digest words (in registers).
// Block 2 is r[31], 0x80, zeros and the bit length 520: its words 1..15
// are constants, and with the rounds unrolled the compiler folds them into
// the schedule.
CTT_HD void sha256_inner65(const uint32_t l[8], const uint32_t r[8], uint32_t st[8]) {
  uint32_t w[16];
  w[0] = prmt(l[0], 0x01u, 0x4321u);  // (prev << 24) | (cur >> 8)
#pragma unroll
  for (int q = 1; q < 8; ++q) w[q] = prmt(l[q], l[q - 1], 0x4321u);
  w[8] = prmt(r[0], l[7], 0x4321u);
#pragma unroll
  for (int q = 9; q < 16; ++q) w[q] = prmt(r[q - 8], r[q - 9], 0x4321u);
  sha256_init(st);
  sha256_compress(st, w);
  w[0] = prmt(0x00800000u, r[7], 0x4210u);  // r[31], 0x80, 0, 0
#pragma unroll
  for (int q = 1; q < 15; ++q) w[q] = 0u;
  w[15] = 65u * 8u;
  sha256_compress(st, w);
}

CTT_HD void store_digest(const uint32_t st[8], uint8_t* out) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    out[4 * i + 0] = static_cast<uint8_t>(st[i] >> 24);
    out[4 * i + 1] = static_cast<uint8_t>(st[i] >> 16);
    out[4 * i + 2] = static_cast<uint8_t>(st[i] >> 8);
    out[4 * i + 3] = static_cast<uint8_t>(st[i]);
  }
}

// --- message sources -------------------------------------------------------

// `[prefix] || m[0..L)`: a batch message, with an optional one-byte prefix.  K1, and the RFC-6962 leaf hash sha256(0x00 || root).
struct PrefixedSrc {
  const uint8_t* m;
  uint32_t skip;   // 1 when a prefix byte leads the message, else 0
  uint32_t prefix;
  CTT_HD uint32_t byte(uint32_t p) const { return p < skip ? prefix : m[p - skip]; }
  CTT_HD uint32_t word(uint32_t p) const {
    if (p >= skip) return load_be(m + (p - skip));
    return (prefix << 24) | (uint32_t(m[0]) << 16) | (uint32_t(m[1]) << 8) | m[2];
  }
};

}  // namespace ctt
