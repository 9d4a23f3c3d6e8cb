// K1 `sha256_batch`: SHA-256 of n equal-length messages, uint8[n, L] ->
// uint8[n, 32], optionally of `prefix || message`.
//
// Replaces: celestia_tpu/ops/sha256.py:100 `sha256` (jit `_sha256_jit` :129,
// entry `sha256_np` :133), which runs the compression as uint32 vector ops
// over the batch.
//
// Bound on the H100: integer issue.  A compression is ~1.5 k 32-bit integer
// operations for 64 bytes of input, far above the 3.35 TB/s of HBM at the
// card's ~16.7 T int32 op/s (132 SMs x 64 INT32 lanes x 1.98 GHz).
// Design: one thread per message, the state and the 16-word schedule window
// in registers, rotations as `__funnelshift_r`, big-endian loads as
// `__byte_perm` of aligned words, and the padding block produced from L in
// registers (sha256.cuh).  Loads are not coalesced (a thread walks its own
// message); that costs little against the integer work and is left to a
// later version.
#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

__global__ void sha256_batch_kernel(const uint8_t* msgs, uint8_t* out, uint64_t n, uint32_t L,
                                    uint32_t skip, uint32_t prefix) {
  const uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t st[8];
  ctt::sha256_message(ctt::PrefixedSrc{msgs + i * L, skip, prefix}, L + skip, st);
  ctt::store_digest(st, out + i * 32u);
}

}  // namespace

// prefix < 0: hash the messages as they are; else hash `prefix || message`.
extern "C" int ctt_sha256_batch(const void* msgs, void* out, long long n, int L, int prefix,
                                void* stream) {
  const int threads = 128;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  sha256_batch_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(msgs), static_cast<uint8_t*>(out),
      static_cast<uint64_t>(n), static_cast<uint32_t>(L), prefix >= 0 ? 1u : 0u,
      static_cast<uint32_t>(prefix >= 0 ? prefix : 0));
  return static_cast<int>(cudaGetLastError());
}
