"""GF(2^8) arithmetic and Reed-Solomon matrices (host side, numpy).

This is the TPU build's equivalent of the reference's erasure codec
(rsmt2d.Codec backed by klauspost/reedsolomon "Leopard", selected at
pkg/appconsts/global_consts.go:91-92).  Instead of an
O(n log n) FFT codec with SIMD assembly, we use a systematic
Lagrange-evaluation RS code whose encode/decode are *matrices* over GF(256),
lowered to GF(2) bit-matrices so the device can run them as plain integer
matmuls on the MXU (see ops/rs.py).  For the protocol's k <= 128 this is
exact, deterministic, and maps perfectly onto the 128x128 systolic array.

Code definition: a row of k data shares is a polynomial sampled at k field
points; parity shares are its evaluations at k more points.  Any k of the
2k points reconstruct the rest (Lagrange interpolation) — the same
25%-withholding recovery property rsmt2d relies on for DAS.  Two codecs
share this machinery (see "codec selection" below): "leopard-ff8"
reproduces the reference chain's Leopard parity bytes exactly, and
"lagrange-gf256" is the original standard-basis code.

Field: GF(2^8) with primitive polynomial 0x11D (x^8+x^4+x^3+x^2+1).
All matrices here are cached per square size; everything downstream is
bit-exact across backends because the device path is integer-only.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_PRIM_POLY = 0x11D
_ORDER = 255

# --- log/antilog tables -----------------------------------------------------


def _build_tables():
    exp = np.zeros(512, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(_ORDER):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _PRIM_POLY
    for i in range(_ORDER, 512):
        exp[i] = exp[i - _ORDER]
    return exp, log


GF_EXP, GF_LOG = _build_tables()


# --- codec selection ---------------------------------------------------------
#
# Two share codecs, selectable per chain (pinned in genesis, ADR-012):
#
# - "leopard-ff8" (DEFAULT): byte-compatible with the reference chain's
#   Leopard codec (rsmt2d.NewLeoRSCodec at
#   pkg/appconsts/global_consts.go:91-92, backed by
#   klauspost/reedsolomon's port of catid/leopard FF8).  Leopard's tables
#   represent field elements in the CANTOR-INDEX domain: byte value v
#   stands for the field element C(v) = XOR of Cantor basis vectors
#   selected by v's bits, and multiplication is conjugated through that
#   bijection.  A systematic MDS RS code's parity is uniquely determined
#   by the field, the evaluation points, and the data/parity position
#   layout — independent of the encode algorithm — so the MXU matmul
#   pipeline reproduces Leopard's exact parity bytes by simply using the
#   conjugated field tables and Leopard's high-rate layout (parity at
#   positions [0, k), data at [k, 2k); position -> point is XOR with k).
#   Multiplication by a constant is still GF(2)-linear in the operand's
#   bits (C is GF(2)-linear), so the bit-matrix lift below is unchanged.
# - "lagrange-gf256": this repo's original codec (points 0..2k-1 in the
#   standard polynomial basis, data first).  Kept for chains that pinned
#   it at genesis before ADR-012.

CODEC_LEOPARD = "leopard-ff8"
CODEC_LAGRANGE = "lagrange-gf256"
CODECS = (CODEC_LEOPARD, CODEC_LAGRANGE)

# catid/leopard FF8 Cantor basis: beta_0 = 1 and each beta_i is the
# lexicographically smaller root of x^2 + x = beta_{i-1} in
# GF(2^8)/0x11D (derivation pinned by tests/test_leopard_codec.py).
CANTOR_BASIS = (1, 214, 152, 146, 86, 200, 88, 230)


def _build_leopard_tables():
    """Field tables for the Cantor-index representation: byte v stands
    for field element C(v); mul'(a, b) = C^-1(C(a) * C(b))."""
    C = np.zeros(256, dtype=np.uint8)
    for j, beta in enumerate(CANTOR_BASIS):
        w = 1 << j
        C[w : 2 * w] = C[:w] ^ beta
    Cinv = np.zeros(256, dtype=np.uint8)
    Cinv[C] = np.arange(256, dtype=np.uint8)
    assert C[1] == 1, "C(1) must be the multiplicative identity"
    log = GF_LOG[C.astype(np.int32)].copy()  # log'[v] = log2(C(v))
    exp = np.zeros(512, dtype=np.int32)
    exp[:_ORDER] = Cinv[GF_EXP[:_ORDER]]
    exp[_ORDER : 2 * _ORDER] = exp[:_ORDER]
    return exp, log


LEO_EXP, LEO_LOG = _build_leopard_tables()

_FIELD_TABLES = {
    CODEC_LAGRANGE: (GF_EXP, GF_LOG),
    CODEC_LEOPARD: (LEO_EXP, LEO_LOG),
}

_ACTIVE_CODEC = CODEC_LEOPARD

# Pin-once-at-genesis enforcement: once ops/rs.py has extended a square
# with the active codec's tables (the first "use"), a codec SWITCH outside
# tests hard-fails instead of silently re-keying every downstream artifact.
# The guard documents and enforces the INVARIANT: the codec is a consensus
# constant pinned at genesis (ADR-012), one chain per process, and
# everything keyed by it after first use — the field tables and encode
# matrices uploaded to the card, the min-DAH cache in da/dah.py — assumes
# it never changes underneath them.  This flag is the port's own: the JAX
# package keeps a separate one, and tests pin both packages together.
_codec_used = False


def active_codec() -> str:
    return _ACTIVE_CODEC


def mark_codec_used() -> None:
    """Called by ops/rs.py when it first extends with the active codec's
    field tables; from then on the active codec is frozen (see below)."""
    global _codec_used
    _codec_used = True


def codec_used() -> bool:
    return _codec_used


def _in_tests() -> bool:
    import os

    return "PYTEST_CURRENT_TEST" in os.environ


def set_active_codec(codec: str, force: bool = False) -> None:
    """Select the share codec process-wide (one chain per process; the
    app pins this from genesis at init — ADR-012).

    Re-pinning the SAME codec is always a no-op.  Switching codecs after
    the first extension refuses outside tests (``force=True`` or a
    running pytest session overrides — tests exercise both codecs in one
    process and re-derive every cached artifact per codec key)."""
    global _ACTIVE_CODEC
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r}; expected one of {CODECS}")
    if (
        codec != _ACTIVE_CODEC
        and _codec_used
        and not force
        and not _in_tests()
    ):
        raise RuntimeError(
            f"cannot switch the share codec from {_ACTIVE_CODEC!r} to "
            f"{codec!r}: the codec is a consensus constant pinned at genesis "
            "(ADR-012) and this process already computed with the active "
            "codec's field tables.  Start a fresh process for a chain with "
            "a different codec."
        )
    _ACTIVE_CODEC = codec


def _resolve(codec):
    return _ACTIVE_CODEC if codec is None else codec


def field_tables(codec: str = None):
    """(exp, log) int32 tables for the codec's field representation."""
    return _FIELD_TABLES[_resolve(codec)]


def position_points(positions, k: int, codec: str = None):
    """Map EDS axis positions (0..2k-1; data then parity) to field points.

    Leopard's high-rate layout puts parity at points [0, k) and data at
    [k, 2k); with k a power of two that is XOR with k.  The Lagrange
    codec evaluates data at 0..k-1 and parity at k..2k-1 directly."""
    pos = np.asarray(positions)
    if _resolve(codec) == CODEC_LEOPARD:
        return pos ^ k
    return pos


def gf_mul(a, b, codec: str = None):
    """Element-wise GF(256) multiply over numpy uint8 arrays (or scalars),
    in the active codec's field representation."""
    exp, log = field_tables(codec)
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = exp[(log[a.astype(np.int32)] + log[b.astype(np.int32)]) % _ORDER]
    out = np.where((a == 0) | (b == 0), 0, out)
    return out.astype(np.uint8)


def gf_inv(a, codec: str = None):
    exp, log = field_tables(codec)
    a = np.asarray(a, dtype=np.uint8)
    if np.any(a == 0):
        raise ZeroDivisionError("GF(256) inverse of zero")
    return exp[(_ORDER - log[a.astype(np.int32)]) % _ORDER].astype(np.uint8)


def gf_div(a, b, codec: str = None):
    return gf_mul(a, gf_inv(b, codec), codec)


def gf_matmul(a: np.ndarray, b: np.ndarray, codec: str = None) -> np.ndarray:
    """GF(256) matrix product (host reference; small matrices only)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for j in range(a.shape[1]):
        prod = gf_mul(a[:, j : j + 1], b[j : j + 1, :], codec)
        out ^= prod
    return out


def mul_table(codec: str = None) -> np.ndarray:
    """Full 256x256 multiplication table for the codec's field."""
    v = np.arange(256, dtype=np.uint8)
    return gf_mul(v[:, None], v[None, :], codec)


# --- Lagrange evaluation matrices -------------------------------------------


def lagrange_matrix(
    src_points: np.ndarray, dst_points: np.ndarray, codec: str = None
) -> np.ndarray:
    """M[i, j] such that f(dst_i) = sum_j M[i,j] * f(src_j) in GF(256)
    (the codec's field representation).

    src_points must be distinct; dst may overlap src (rows become unit rows).
    Vectorized via log-domain products.
    """
    exp, log = field_tables(codec)
    src = np.asarray(src_points, dtype=np.uint8)
    dst = np.asarray(dst_points, dtype=np.uint8)
    k = len(src)
    if len(np.unique(src)) != k:
        raise ValueError("source points must be distinct")
    # denom_j = prod_{m != j} (src_j ^ src_m)
    diff_ss = src[None, :] ^ src[:, None]  # [j, m]
    np.fill_diagonal(diff_ss, 1)  # neutral in the product
    denom_log = log[diff_ss.astype(np.int32)].sum(axis=1) % _ORDER  # [j]
    # num_{i,j} = prod_{m != j} (dst_i ^ src_m)
    diff_ds = dst[:, None] ^ src[None, :]  # [i, m]
    zero_mask = diff_ds == 0  # dst_i == src_m
    safe = np.where(zero_mask, 1, diff_ds)
    log_all = log[safe.astype(np.int32)]
    total_log = log_all.sum(axis=1)  # [i] — includes m == j term
    n_zeros = zero_mask.sum(axis=1)  # [i]
    M = np.zeros((len(dst), k), dtype=np.uint8)
    for i in range(len(dst)):
        if n_zeros[i] > 0:
            # dst_i coincides with some src point: unit row.
            j = int(np.nonzero(zero_mask[i])[0][0])
            M[i, j] = 1
            continue
        num_log = (total_log[i] - log_all[i]) % _ORDER  # [j]
        M[i] = exp[(num_log - denom_log) % _ORDER]
    return M


@lru_cache(maxsize=None)
def _encode_matrix_cached(k: int, codec: str) -> np.ndarray:
    pos = np.arange(2 * k)
    pts = position_points(pos, k, codec).astype(np.uint8)
    return lagrange_matrix(pts[:k], pts[k:], codec)


def encode_matrix(k: int, codec: str = None) -> np.ndarray:
    """E (k x k): parity at positions k..2k-1 from data at 0..k-1."""
    if not 1 <= k <= 128:
        raise ValueError(f"square size k must be in [1, 128], got {k}")
    return _encode_matrix_cached(k, _resolve(codec))


def decode_matrix(
    known_positions: np.ndarray, k: int, codec: str = None
) -> np.ndarray:
    """D (2k x k): all 2k positions from the k known-position shares."""
    known = np.asarray(known_positions)
    if len(known) != k:
        raise ValueError(f"need exactly {k} known positions, got {len(known)}")
    codec = _resolve(codec)
    src = position_points(known, k, codec).astype(np.uint8)
    dst = position_points(np.arange(2 * k), k, codec).astype(np.uint8)
    return lagrange_matrix(src, dst, codec)


def decode_matrices_batch(
    known_batch: np.ndarray, k: int, codec: str = None
) -> np.ndarray:
    """Per-axis decode matrices, vectorized: known_batch uint8[n, k] (each
    row k distinct POSITIONS in 0..2k-1) -> D uint8[n, 2k, k].

    The fully-vectorized form of :func:`decode_matrix` over a batch of
    axes — repair of a DAS-withheld square needs one matrix per axis (every
    axis can have a different availability mask), and building them one
    Python call at a time dominates repair time at k=128.
    """
    codec = _resolve(codec)
    exp, log = field_tables(codec)
    positions = np.asarray(known_batch, dtype=np.uint8)
    n = positions.shape[0]
    if positions.shape != (n, k):
        raise ValueError(f"known_batch must be (n, {k}), got {positions.shape}")
    # consensus-critical math must fail loud: a repeated point would turn
    # the log-domain denominators into silent garbage
    sorted_src = np.sort(positions, axis=1)
    if k > 1 and (sorted_src[:, 1:] == sorted_src[:, :-1]).any():
        raise ValueError("source points must be distinct within each axis")
    src = position_points(positions, k, codec).astype(np.uint8)
    dst = position_points(np.arange(2 * k), k, codec).astype(np.uint8)
    # denominators: denom_log[b, j] = sum_{m != j} log(src_j ^ src_m)
    diff_ss = src[:, None, :] ^ src[:, :, None]  # [b, j, m]
    diag = np.arange(k)
    diff_ss[:, diag, diag] = 1  # neutral in the log-sum
    denom_log = log[diff_ss.astype(np.int32)].sum(axis=2) % _ORDER  # [b, j]
    # numerators: for every dst_i, prod_{m != j} (dst_i ^ src_m)
    diff_ds = dst[None, :, None] ^ src[:, None, :]  # [b, i, m]
    zero_mask = diff_ds == 0  # dst_i == src_m (at most one m per (b, i))
    safe = np.where(zero_mask, 1, diff_ds)
    log_all = log[safe.astype(np.int32)]  # [b, i, m]
    total_log = log_all.sum(axis=2)  # [b, i]
    has_zero = zero_mask.any(axis=2)  # [b, i]
    num_log = (total_log[:, :, None] - log_all) % _ORDER  # [b, i, j]
    lagrange = exp[(num_log - denom_log[:, None, :]) % _ORDER]
    # rows where dst coincides with a src point are unit rows — zero_mask
    # is exactly that one-hot (src points are distinct per axis)
    return np.where(
        has_zero[:, :, None], zero_mask.astype(np.uint8), lagrange
    ).astype(np.uint8)


# --- GF(2) bit-expansion ----------------------------------------------------
#
# Multiplication by a constant c in GF(2^8) is GF(2)-linear on the bits of the
# operand: bit s of (c*b) = XOR_t M_c[s,t]*b_t with M_c[s,t] = bit s of
# (c * 2^t).  A GF(256) matrix A (m x n) therefore lifts to a binary matrix
# A_bits (8m x 8n) and "y = A x over GF(256)" becomes
# "y_bits = A_bits @ x_bits mod 2" — an integer matmul the MXU executes
# natively (int8 inputs, int32 accumulation), with the mod-2 as a cheap
# elementwise mask.


def bit_expand_matrix(A: np.ndarray, codec: str = None) -> np.ndarray:
    """Lift a GF(256) matrix (m x n) to its GF(2) form (8m x 8n), int8 0/1.

    Row index i*8+s = output bit s of GF-row i; column index j*8+t = input
    bit t of GF-column j.  Valid for BOTH codec representations:
    multiplication by a constant stays GF(2)-linear in the operand's bits
    under the Cantor-index conjugation (C is GF(2)-linear).
    """
    A = np.asarray(A, dtype=np.uint8)
    m, n = A.shape
    powers = (np.uint8(1) << np.arange(8, dtype=np.uint8))  # 2^t
    # prod[m_i, n_j, t] = A[i,j] * 2^t in the codec's field
    prod = gf_mul(A[:, :, None], powers[None, None, :], codec)  # (m, n, 8)
    # bits[s] of prod -> out[(i,s),(j,t)]
    s_idx = np.arange(8, dtype=np.uint8)
    bits = (prod[:, :, None, :] >> s_idx[None, None, :, None]) & 1  # (m, n, s, t)
    out = bits.transpose(0, 2, 1, 3).reshape(8 * m, 8 * n)
    return out.astype(np.int8)


@lru_cache(maxsize=None)
def _encode_matrix_bits_cached(k: int, codec: str) -> np.ndarray:
    return bit_expand_matrix(encode_matrix(k, codec), codec)


def encode_matrix_bits(k: int, codec: str = None) -> np.ndarray:
    """Bit-expanded encode matrix (8k x 8k), int8 0/1 — the MXU operand."""
    return _encode_matrix_bits_cached(k, _resolve(codec))


# --- Host reference encode (for bit-exactness tests) ------------------------


def encode_shares_ref(data: np.ndarray, codec: str = None) -> np.ndarray:
    """Reference row-encode: data (k, B) uint8 -> parity (k, B) uint8.

    Direct table-lookup GF matmul; the device path in ops/rs.py must match
    this bit-for-bit.
    """
    data = np.asarray(data, dtype=np.uint8)
    k = data.shape[0]
    E = encode_matrix(k, codec)
    out = np.zeros_like(data)
    for j in range(k):
        out ^= gf_mul(E[:, j : j + 1], data[j : j + 1, :], codec)
    return out
