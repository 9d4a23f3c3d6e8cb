"""Batched SHA-256: the CUDA kernel K1 and its plain PyTorch twin.

Counterpart of ``celestia_tpu/ops/sha256.py``.  The DA workload is
thousands of independent SHA-256 calls of a few fixed lengths per block
(542-byte NMT leaves, 181-byte NMT nodes, 91/65-byte RFC-6962 nodes).

* On a CUDA tensor :func:`sha256` launches ``sha256_batch``
  (``csrc/sha256.cu``): one thread per message, state and schedule in
  registers, padding produced in the kernel.
* On a CPU tensor it runs :func:`sha256_plain`, the same compression as
  vectorised PyTorch ops over the batch.  CPU ``uint32`` tensors have no
  ``+``, ``>>``, ``<<`` or ``~`` and ``int32 >>`` is arithmetic, so the
  plain version works in int64 lanes masked to 32 bits.

Bit-exact with hashlib by construction (integer ops only); tested.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from celestia_tpu_torch import kernels

_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

_H0 = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

_M32 = 0xFFFFFFFF


def _rotr(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x >> r) | (x << (32 - r))) & _M32


def _compress(state, w):
    """One compression: state = 8 int64 tensors, w = 16 int64 tensors, all
    holding 32-bit values."""
    w = list(w)
    for i in range(16, 64):
        w15, w2 = w[i - 15], w[i - 2]
        s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
        s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = state
    for i in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + _K[i] + w[i]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & _M32
        d, c, b, a = c, b, a, (t1 + s0 + maj) & _M32
    return [(s + v) & _M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]


@lru_cache(maxsize=None)
def _padding_bytes(msg_len: int) -> np.ndarray:
    """The constant SHA-256 padding for a message of ``msg_len`` bytes."""
    rem = (msg_len + 1 + 8) % 64
    zero_pad = (64 - rem) % 64
    pad = bytearray([0x80]) + bytes(zero_pad) + (msg_len * 8).to_bytes(8, "big")
    return np.frombuffer(bytes(pad), dtype=np.uint8)


def sha256_plain(msgs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch SHA-256 of equal-length messages, on any device:
    uint8[..., L] -> uint8[..., 32]."""
    if msgs.dtype != torch.uint8:
        raise ValueError(f"msgs must be uint8, got {msgs.dtype}")
    L = msgs.shape[-1]
    lead = tuple(msgs.shape[:-1])
    n = int(np.prod(lead))
    flat = msgs.reshape(n, L)
    pad = torch.from_numpy(_padding_bytes(L).copy()).to(msgs.device)
    data = torch.cat([flat, pad.expand(n, -1)], dim=-1)
    n_blocks = data.shape[-1] // 64
    b = data.reshape(-1, n_blocks, 16, 4).to(torch.int64)
    words = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
    state = [torch.full((n,), h, dtype=torch.int64, device=msgs.device) for h in _H0]
    for blk in range(n_blocks):
        state = _compress(state, [words[:, blk, i] for i in range(16)])
    out = torch.stack(
        [(s >> sh) & 0xFF for s in state for sh in (24, 16, 8, 0)], dim=-1
    )
    return out.to(torch.uint8).reshape(lead + (32,))


def sha256_cuda(msgs: torch.Tensor, prefix: int = -1) -> torch.Tensor:
    """Launch K1 ``sha256_batch``: uint8[..., L] on the card -> uint8[..., 32],
    the digests of ``bytes([prefix]) + message`` when ``prefix >= 0``."""
    kernels.check_cuda_tensor(msgs, "msgs")
    if not -1 <= prefix <= 255:
        raise ValueError(f"prefix must be a byte or -1, got {prefix}")
    L = msgs.shape[-1]
    out = torch.empty(tuple(msgs.shape[:-1]) + (32,), dtype=torch.uint8, device=msgs.device)
    n = out.numel() // 32
    if n:
        kernels.launch(
            "sha256_batch", msgs.device, msgs.data_ptr(), out.data_ptr(), n, L, prefix
        )
    return out


def sha256(msgs: torch.Tensor) -> torch.Tensor:
    """SHA-256 of a batch of equal-length messages: uint8[..., L] -> uint8[..., 32].

    The kernel on a CUDA tensor, the plain version on a CPU tensor; a
    standalone dispatch, so it carries the devprof bracket (JAX :144)."""
    from celestia_tpu_torch.utils import devprof

    d = devprof.dispatch("sha256_batch", msgs.device, msg_len=int(msgs.shape[-1]),
                         n=msgs.numel() // max(1, msgs.shape[-1]))
    if msgs.device.type == "cpu":
        return d.done(sha256_plain(msgs))
    return d.done(sha256_cuda(msgs))


def sha256_np(msgs: np.ndarray, device=None) -> np.ndarray:
    """Numpy in and out (JAX :133): :func:`sha256` on ``device`` (None:
    the card, K1; ``"cpu"``: the plain version) under its ``sha256_batch``
    bracket.  K1's only entry point: no path of the port launches K1."""
    from celestia_tpu_torch.utils.device import resolve_device

    msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
    t = torch.from_numpy(msgs if msgs.flags.writeable else msgs.copy())
    return sha256(t.to(resolve_device(device))).cpu().numpy()


def sha256_batch_host(msgs: np.ndarray) -> np.ndarray:
    """Batched SHA-256 on the host with hashlib: uint8[n, L] -> uint8[n, 32]."""
    import hashlib

    msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
    if msgs.ndim != 2:
        raise ValueError(f"msgs must be [n, L], got {msgs.shape}")
    out = np.zeros((msgs.shape[0], 32), dtype=np.uint8)
    for i in range(msgs.shape[0]):
        out[i] = np.frombuffer(hashlib.sha256(msgs[i].tobytes()).digest(), dtype=np.uint8)
    return out
