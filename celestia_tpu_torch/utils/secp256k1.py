"""secp256k1 ECDSA (pure Python) — tx signing/verification primitives.

Equivalent role to the reference's decred secp256k1 dependency
(SURVEY.md §2.2 "BLS / secp256k1 / SHA"): account-key signatures over
SIGN_MODE_DIRECT-style sign bytes.  Deterministic nonces per RFC 6979 so
signing is reproducible.  Pure Python is adequate for the host-side tx path
(the device does the DA compute); a native C++ path can slot in behind the
same interface later.
"""

from __future__ import annotations

import hashlib
import hmac
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Tuple

# Curve parameters (SEC2 secp256k1)
P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
Gx = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
Gy = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def _point_add(p1: Optional[Tuple[int, int]], p2: Optional[Tuple[int, int]]):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and (y1 + y2) % P == 0:
        return None
    if p1 == p2:
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def _point_mul(k: int, point: Tuple[int, int]):
    result = None
    addend = point
    while k:
        if k & 1:
            result = _point_add(result, addend)
        addend = _point_add(addend, addend)
        k >>= 1
    return result


@dataclass(frozen=True)
class PrivateKey:
    d: int

    @classmethod
    def from_seed(cls, seed: bytes) -> "PrivateKey":
        """Derive a valid key deterministically from arbitrary seed bytes."""
        d = 0
        counter = 0
        while not 1 <= d < N:
            d = int.from_bytes(
                hashlib.sha256(seed + counter.to_bytes(4, "big")).digest(), "big"
            )
            counter += 1
        return cls(d)

    def public_key(self) -> "PublicKey":
        x, y = _point_mul(self.d, (Gx, Gy))
        return PublicKey(x, y)

    def sign(self, msg: bytes) -> bytes:
        """Deterministic ECDSA (RFC 6979, SHA-256); 64-byte r||s, low-s."""
        z = int.from_bytes(hashlib.sha256(msg).digest(), "big") % N
        k = _rfc6979_k(self.d, hashlib.sha256(msg).digest())
        while True:
            R = _point_mul(k, (Gx, Gy))
            r = R[0] % N
            if r == 0:
                k = (k + 1) % N
                continue
            s = _inv(k, N) * (z + r * self.d) % N
            if s == 0:
                k = (k + 1) % N
                continue
            if s > N // 2:  # canonical low-s
                s = N - s
            return r.to_bytes(32, "big") + s.to_bytes(32, "big")


def _rfc6979_k(d: int, h1: bytes) -> int:
    x = d.to_bytes(32, "big")
    V = b"\x01" * 32
    K = b"\x00" * 32
    K = hmac.new(K, V + b"\x00" + x + h1, hashlib.sha256).digest()
    V = hmac.new(K, V, hashlib.sha256).digest()
    K = hmac.new(K, V + b"\x01" + x + h1, hashlib.sha256).digest()
    V = hmac.new(K, V, hashlib.sha256).digest()
    while True:
        V = hmac.new(K, V, hashlib.sha256).digest()
        k = int.from_bytes(V, "big")
        if 1 <= k < N:
            return k
        K = hmac.new(K, V + b"\x00", hashlib.sha256).digest()
        V = hmac.new(K, V, hashlib.sha256).digest()


@dataclass(frozen=True)
class PublicKey:
    x: int
    y: int

    def compressed(self) -> bytes:
        return bytes([2 + (self.y & 1)]) + self.x.to_bytes(32, "big")

    @classmethod
    def from_compressed(cls, raw: bytes) -> "PublicKey":
        # decompression costs a modular sqrt; the same few pubkeys repeat
        # across a block's txs, so memoize (instances are frozen).  The
        # cached helper raises for invalid encodings like the inline path.
        return _decompress_cached(bytes(raw))

    def verify(self, msg: bytes, sig: bytes) -> bool:
        pre = _verify_scalars(msg, sig)
        if pre is None:
            return False
        r, u1, u2 = pre
        x = _ecmul_double_x(u1, u2, self)
        if x is None:
            return False
        return x % N == r

    def address(self) -> bytes:
        """20-byte account address: sha256(compressed pubkey)[:20]."""
        return hashlib.sha256(self.compressed()).digest()[:20]


@lru_cache(maxsize=4096)
def _decompress_cached(raw: bytes) -> PublicKey:
    if len(raw) != 33 or raw[0] not in (2, 3):
        raise ValueError("invalid compressed pubkey")
    x = int.from_bytes(raw[1:], "big")
    if x >= P:
        raise ValueError("pubkey x out of range")
    y2 = (pow(x, 3, P) + 7) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        raise ValueError("point not on curve")
    if (y & 1) != (raw[0] & 1):
        y = P - y
    return PublicKey(x, y)


MULTISIG_PREFIX = 0xF0


@dataclass(frozen=True)
class MultisigPubKey:
    """k-of-n threshold key over compressed secp256k1 keys.

    Parity role: the SDK's LegacyAminoPubKey multisig accepted by the
    reference's ante chain (SURVEY §2.1 ante 'multisig pubkeys').  Wire
    form: 0xF0 | threshold | n | 33-byte keys...; the signature blob is a
    concatenation of (key index byte | 64-byte r||s) entries.
    """

    threshold: int
    keys: Tuple[bytes, ...]  # compressed pubkeys, order-significant

    def __post_init__(self):
        if not 1 <= self.threshold <= len(self.keys):
            raise ValueError(
                f"threshold {self.threshold} out of range for "
                f"{len(self.keys)} keys"
            )
        if len(self.keys) > 255:
            raise ValueError("at most 255 keys in a multisig")
        for k in self.keys:
            if len(k) != 33 or k[0] not in (2, 3):
                raise ValueError("multisig member must be a compressed pubkey")

    def marshal(self) -> bytes:
        out = bytearray([MULTISIG_PREFIX, self.threshold, len(self.keys)])
        for k in self.keys:
            out += k
        return bytes(out)

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MultisigPubKey":
        if len(raw) < 3 or raw[0] != MULTISIG_PREFIX:
            raise ValueError("not a multisig pubkey")
        threshold, n = raw[1], raw[2]
        if len(raw) != 3 + 33 * n:
            raise ValueError("truncated multisig pubkey")
        keys = tuple(raw[3 + 33 * i : 3 + 33 * (i + 1)] for i in range(n))
        return cls(threshold, keys)

    def address(self) -> bytes:
        return hashlib.sha256(self.marshal()).digest()[:20]

    def verify(self, msg: bytes, sig_blob: bytes) -> bool:
        """Canonical threshold verification: >= threshold entries, EVERY
        entry must be a valid signature by a distinct member, and entries
        must appear in strictly increasing index order.  Tolerating any
        invalid or reordered entry would make the signature blob — and
        therefore the tx hash — third-party malleable (the SDK's
        LegacyAminoPubKey verification rejects such blobs the same way)."""
        entry = 1 + 64
        if not sig_blob or len(sig_blob) % entry:
            return False
        n_entries = len(sig_blob) // entry
        if not self.threshold <= n_entries <= len(self.keys):
            return False
        last_idx = -1
        for off in range(0, len(sig_blob), entry):
            idx = sig_blob[off]
            if idx >= len(self.keys) or idx <= last_idx:
                return False  # unknown signer or non-canonical order
            last_idx = idx
            sig = sig_blob[off + 1 : off + entry]
            try:
                pk = PublicKey.from_compressed(self.keys[idx])
            except ValueError:
                return False
            if not pk.verify(msg, sig):
                return False  # any bad entry invalidates the whole blob
        return True


def combine_multisig_signatures(entries) -> bytes:
    """[(key_index, 64-byte sig), ...] -> the tx signature blob."""
    out = bytearray()
    for idx, sig in sorted(entries):
        if len(sig) != 64:
            raise ValueError("each partial signature must be 64 bytes")
        out += bytes([idx]) + sig
    return bytes(out)


def _verify_scalars(msg: bytes, sig: bytes):
    """Shared ECDSA pre-checks + scalar math; (r, u1, u2) or None.

    Rejects non-canonical high-s signatures: accepting (r, N-s) alongside
    (r, s) lets any third party malleate an in-flight tx into a different tx
    hash that still executes — breaking confirm-by-hash lookup and mempool
    dedup.  Mirrors the low-s rule sign() enforces and the reference's
    secp256k1 behavior (SURVEY.md §2.2).
    """
    if len(sig) != 64:
        return None
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    if not (1 <= r < N and 1 <= s < N):
        return None
    if s > N // 2:
        return None
    z = int.from_bytes(hashlib.sha256(msg).digest(), "big") % N
    w = _inv(s, N)
    return r, z * w % N, r * w % N


# --- GLV endomorphism (verification speedup) -------------------------------
# secp256k1 has an efficient endomorphism phi(x, y) = (beta*x, y) with
# phi(P) = lambda*P (beta, lambda the matching cube roots of unity mod p
# and mod N).  Splitting a 256-bit scalar k into k1 + k2*lambda with
# |k1|, |k2| ~ 2^128 (lattice rounding below, the standard GLV basis)
# halves the doubling count of the native wNAF loop.  The split runs here
# in Python (CPython bigints), the point math in native C++.
GLV_LAMBDA = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
_GLV_A1 = 0x3086D221A7D46BCDE86C90E49284EB15
_GLV_B1 = -0xE4437ED6010E88286F547FA90ABFE4C3
_GLV_A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
_GLV_B2 = _GLV_A1


def _glv_split(k: int):
    """k -> (k1, k2) with k1 + k2*GLV_LAMBDA ≡ k (mod N), both ~128-bit."""
    c1 = (_GLV_B2 * k + N // 2) // N
    c2 = (-_GLV_B1 * k + N // 2) // N
    k1 = k - c1 * _GLV_A1 - c2 * _GLV_A2
    k2 = -c1 * _GLV_B1 - c2 * _GLV_B2
    return k1, k2


def _batch_inv(vals, mod):
    """Montgomery's trick: invert every element with ONE modular
    inversion plus 3(n-1) multiplications.  All vals must be non-zero
    mod ``mod`` (signature s-values are range-checked before this)."""
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % mod
    acc = _inv(prefix[n], mod)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * acc % mod
        acc = acc * vals[i] % mod
    return out


def _ecmul_double(u1: int, u2: int, pub: "PublicKey"):
    """u1*G + u2*pub — native C when available, pure Python otherwise."""
    from celestia_tpu_torch.utils import native

    if native.available():
        got = native.ecmul_double(
            u1.to_bytes(32, "big"), u2.to_bytes(32, "big"), pub.compressed()
        )
        if got is None:
            return None
        return int.from_bytes(got[0], "big"), int.from_bytes(got[1], "big")
    return _point_add(_point_mul(u1, (Gx, Gy)), _point_mul(u2, (pub.x, pub.y)))


def _glv_pack(u1: int, u2: int):
    """(ks_row, signs_row) for the native GLV ABI: the four 32-byte
    big-endian magnitudes |k1_G| ‖ |k2_G| ‖ |k1_Q| ‖ |k2_Q| and their
    sign bytes.  The ONE place the component order lives Python-side —
    verify_batch and the single-verify path both marshal through here
    (native/celestia_native.cpp secp256k1_ecmul_double_glv)."""
    parts = _glv_split(u1) + _glv_split(u2)
    ks = b"".join(abs(k).to_bytes(32, "big") for k in parts)
    signs = bytes(1 if k < 0 else 0 for k in parts)
    return ks, signs


def _ecmul_double_x(u1: int, u2: int, pub: "PublicKey"):
    """x(u1*G + u2*pub) or None — ECDSA verification only needs x.
    Prefers the GLV kernel (half the doublings; the single-sig CheckTx
    path gets the same speedup the batch path does) as a batch of one."""
    from celestia_tpu_torch.utils import native

    if native.has_glv():
        import numpy as np

        ks, signs = _glv_pack(u1, u2)
        pubs = np.frombuffer(
            pub.x.to_bytes(32, "big") + pub.y.to_bytes(32, "big"),
            dtype=np.uint8,
        ).reshape(1, 64)
        ok, xs = native.ecmul_double_glv_batch(
            np.frombuffer(ks, dtype=np.uint8).reshape(1, 128),
            np.frombuffer(signs, dtype=np.uint8).reshape(1, 4),
            pubs,
            # celint: allow(hostpool-discipline) — single-signature path:
            # a batch of one has nothing to fan out, and this runs inside
            # ante handlers that may already sit on pool workers
            nthreads=1,
        )
        if not ok[0]:
            return None
        return int.from_bytes(xs[0].tobytes(), "big")
    pt = _ecmul_double(u1, u2, pub)
    return None if pt is None else pt[0]


@lru_cache(maxsize=4096)
def _uncompressed64(raw: bytes):
    """compressed(33B) -> uncompressed(64B x||y) for the native GLV path;
    memoized on top of the memoized sqrt decompression.  Raises
    ValueError for invalid encodings (like from_compressed)."""
    pk = _decompress_cached(raw)
    return pk.x.to_bytes(32, "big") + pk.y.to_bytes(32, "big")


def verify_batch(msgs, sigs, pubkeys, precomp=None) -> list:
    """Verify many (msg, sig, compressed-pubkey) triples at once.

    Uses the threaded native batch path when available (the reference's
    analogue is per-tx C secp256k1 verification inside FilterTxs /
    ProcessProposal — app/validate_txs.go:39-97); falls back to sequential
    verify otherwise.  Returns a list of bools.

    precomp routes the GLV leg's table strategy (see
    native.ecmul_double_glv_batch): None = auto, True/False force the
    precomputed-affine-table / legacy symbol.  Ignored off the GLV path.
    """
    import numpy as np

    from celestia_tpu_torch.utils import native

    n = len(msgs)
    if not (len(sigs) == len(pubkeys) == n):
        raise ValueError("msgs/sigs/pubkeys length mismatch")
    if not native.available():
        out = []
        for msg, sig, raw in zip(msgs, sigs, pubkeys):
            try:
                pk = PublicKey.from_compressed(raw)
            except ValueError:
                out.append(False)
                continue
            out.append(pk.verify(msg, sig))
        return out

    results = [False] * n
    rs = [0] * n
    live = np.zeros(n, dtype=bool)
    # Montgomery batch inversion: ONE modular inversion for the whole
    # batch instead of one per signature (the per-sig s^-1 was a visible
    # slice of FilterTxs host time at proposal scale)
    pre_rsz: list = [None] * n
    s_vals: list = []
    for i, (msg, sig, raw) in enumerate(zip(msgs, sigs, pubkeys)):
        if len(sig) != 64 or len(raw) != 33 or raw[0] not in (2, 3):
            continue
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if not (1 <= r < N and 1 <= s < N) or s > N // 2:
            continue  # low-s rule: see _verify_scalars
        z = int.from_bytes(hashlib.sha256(msg).digest(), "big") % N
        pre_rsz[i] = (r, s, z, len(s_vals))
        s_vals.append(s)
    if s_vals:
        ws = _batch_inv(s_vals, N)
    use_glv = native.has_glv()
    if use_glv:
        # GLV path wants UNCOMPRESSED keys (decompression costs a field
        # sqrt; senders repeat, so the cache amortizes it to ~zero)
        pubs = np.zeros((n, 64), dtype=np.uint8)
        ks = np.zeros((n, 128), dtype=np.uint8)
        sgn = np.zeros((n, 4), dtype=np.uint8)
    else:
        pubs = np.zeros((n, 33), dtype=np.uint8)
        u1s = np.zeros((n, 32), dtype=np.uint8)
        u2s = np.zeros((n, 32), dtype=np.uint8)
    for i in range(n):
        pre = pre_rsz[i]
        if pre is None:
            continue
        r, s, z, j = pre
        w = ws[j]
        u1 = z * w % N
        u2 = r * w % N
        if use_glv:
            try:
                raw_pub = _uncompressed64(bytes(pubkeys[i]))
            except ValueError:
                continue  # invalid pubkey: signature cannot verify
            k_row, s_row = _glv_pack(u1, u2)
            ks[i] = np.frombuffer(k_row, dtype=np.uint8)
            sgn[i] = np.frombuffer(s_row, dtype=np.uint8)
            pubs[i] = np.frombuffer(raw_pub, dtype=np.uint8)
        else:
            u1s[i] = np.frombuffer(u1.to_bytes(32, "big"), dtype=np.uint8)
            u2s[i] = np.frombuffer(u2.to_bytes(32, "big"), dtype=np.uint8)
            pubs[i] = np.frombuffer(pubkeys[i], dtype=np.uint8)
        rs[i] = r
        live[i] = True
    if not live.any():
        return results
    # ship only live rows: dead rows (scalar pre-check / decompression
    # failures) would each pay the kernel's on-curve validation work
    idx = np.flatnonzero(live)
    if use_glv:
        ok, xs = native.ecmul_double_glv_batch(
            ks[idx], sgn[idx], pubs[idx], precomp=precomp
        )
    else:
        ok, xs = native.ecmul_double_batch(u1s[idx], u2s[idx], pubs[idx])
    for j, i in enumerate(idx):
        if ok[j]:
            results[i] = int.from_bytes(xs[j].tobytes(), "big") % N == rs[i]
    return results
