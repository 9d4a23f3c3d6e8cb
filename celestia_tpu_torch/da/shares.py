"""512-byte share encoding/decoding: sparse (blob), compact (tx), padding.

Behavioral parity with go-square/shares as specified in
specs/src/specs/shares.md and the layout constants in
pkg/appconsts/global_consts.go:29-66.

Shares are the atomic unit of the data square.  Layout of every share:

    [29B namespace][1B info (7-bit version | 1-bit sequence-start)]
    [4B big-endian sequence length — first share of a sequence only]
    [4B big-endian reserved bytes   — compact (tx) shares only]
    [payload, zero-filled]

On the host, shares are plain ``bytes``; :func:`shares_to_array` exports a
square as a ``uint8[n, 512]`` numpy array for the device pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from celestia_tpu_torch.appconsts import (
    COMPACT_SHARE_RESERVED_BYTES,
    CONTINUATION_COMPACT_SHARE_CONTENT_SIZE,
    CONTINUATION_SPARSE_SHARE_CONTENT_SIZE,
    FIRST_COMPACT_SHARE_CONTENT_SIZE,
    FIRST_SPARSE_SHARE_CONTENT_SIZE,
    DEFAULT_SHARE_VERSION,
    MAX_SHARE_VERSION,
    NAMESPACE_SIZE,
    SEQUENCE_LEN_BYTES,
    SHARE_INFO_BYTES,
    SHARE_SIZE,
    SUPPORTED_SHARE_VERSIONS,
)
from celestia_tpu_torch.da.namespace import (
    Namespace,
    PRIMARY_RESERVED_PADDING_NAMESPACE,
    TAIL_PADDING_NAMESPACE,
)


@dataclass(frozen=True)
class Share:
    """One 512-byte share."""

    raw: bytes

    def __post_init__(self):
        if len(self.raw) != SHARE_SIZE:
            raise ValueError(f"share must be {SHARE_SIZE} bytes, got {len(self.raw)}")

    @property
    def namespace(self) -> Namespace:
        return Namespace(self.raw[:NAMESPACE_SIZE])

    @property
    def info_byte(self) -> int:
        return self.raw[NAMESPACE_SIZE]

    @property
    def version(self) -> int:
        return self.info_byte >> 1

    @property
    def is_sequence_start(self) -> bool:
        return bool(self.info_byte & 1)

    def sequence_len(self) -> int:
        """Big-endian uint32 sequence length (sequence-start shares only)."""
        if not self.is_sequence_start:
            raise ValueError("sequence length only present on sequence-start shares")
        off = NAMESPACE_SIZE + SHARE_INFO_BYTES
        return int.from_bytes(self.raw[off : off + SEQUENCE_LEN_BYTES], "big")

    def is_compact(self) -> bool:
        from celestia_tpu_torch.da.namespace import (
            PAY_FOR_BLOB_NAMESPACE,
            TRANSACTION_NAMESPACE,
        )

        return self.namespace.raw in (
            TRANSACTION_NAMESPACE.raw,
            PAY_FOR_BLOB_NAMESPACE.raw,
        )

    def reserved_bytes(self) -> int:
        """Compact shares: absolute in-share index of the first unit start (0 = none)."""
        off = NAMESPACE_SIZE + SHARE_INFO_BYTES
        if self.is_sequence_start:
            off += SEQUENCE_LEN_BYTES
        return int.from_bytes(self.raw[off : off + COMPACT_SHARE_RESERVED_BYTES], "big")

    def sparse_payload(self) -> bytes:
        off = NAMESPACE_SIZE + SHARE_INFO_BYTES
        if self.is_sequence_start:
            off += SEQUENCE_LEN_BYTES
        return self.raw[off:]

    def compact_payload(self) -> bytes:
        off = NAMESPACE_SIZE + SHARE_INFO_BYTES
        if self.is_sequence_start:
            off += SEQUENCE_LEN_BYTES
        off += COMPACT_SHARE_RESERVED_BYTES
        return self.raw[off:]


def _info_byte(version: int, sequence_start: bool) -> int:
    if not 0 <= version <= MAX_SHARE_VERSION:
        raise ValueError(f"share version out of range: {version}")
    return (version << 1) | int(sequence_start)


# ---------------------------------------------------------------------------
# Sparse (blob) shares
# ---------------------------------------------------------------------------


def split_blob_into_shares(
    namespace: Namespace, data: bytes, share_version: int = DEFAULT_SHARE_VERSION
) -> List[Share]:
    """Split one blob into its share sequence (specs/shares.md "Share Splitting")."""
    # Padding shares are the only zero-length sequences; blobs must be
    # non-empty (x/blob MsgPayForBlobs validation in the reference) —
    # blob_shares_array enforces both that and the share version.
    # Vectorized layout (one numpy pass instead of per-share bytes
    # concatenation: the square-build hot path at k=128 lays out ~16k
    # shares), wrapped back into Share objects for the layout machinery.
    arr = blob_shares_array(namespace, data, share_version)
    flat = arr.tobytes()
    return [
        Share(flat[i * SHARE_SIZE : (i + 1) * SHARE_SIZE])
        for i in range(arr.shape[0])
    ]


def sparse_shares_needed(blob_len: int) -> int:
    """Number of shares a blob of ``blob_len`` bytes occupies."""
    if blob_len <= FIRST_SPARSE_SHARE_CONTENT_SIZE:
        return 1
    rem = blob_len - FIRST_SPARSE_SHARE_CONTENT_SIZE
    return 1 + -(-rem // CONTINUATION_SPARSE_SHARE_CONTENT_SIZE)


def blob_shares_array(
    namespace: Namespace, data: bytes, share_version: int = DEFAULT_SHARE_VERSION
) -> "np.ndarray":
    """Vectorized split_blob_into_shares: uint8[n, 512] directly, no Share
    objects.  Bit-identical to the per-share path (asserted in tests); used
    where only the tensor is needed (commitment recompute runs once per
    blob per proposal — the Python share loop dominated that host cost)."""
    import numpy as np

    if share_version not in SUPPORTED_SHARE_VERSIONS:
        raise ValueError(f"unsupported share version {share_version}")
    if len(data) == 0:
        raise ValueError("blob data must be non-empty")
    n = sparse_shares_needed(len(data))
    arr = np.zeros((n, SHARE_SIZE), dtype=np.uint8)
    ns = np.frombuffer(namespace.raw, dtype=np.uint8)
    arr[:, :NAMESPACE_SIZE] = ns
    info_off = NAMESPACE_SIZE
    arr[0, info_off] = _info_byte(share_version, True)
    if n > 1:
        arr[1:, info_off] = _info_byte(share_version, False)
    seq_off = info_off + SHARE_INFO_BYTES
    arr[0, seq_off : seq_off + SEQUENCE_LEN_BYTES] = np.frombuffer(
        len(data).to_bytes(SEQUENCE_LEN_BYTES, "big"), dtype=np.uint8
    )
    first_off = seq_off + SEQUENCE_LEN_BYTES
    buf = np.frombuffer(data, dtype=np.uint8)
    first_n = min(len(data), FIRST_SPARSE_SHARE_CONTENT_SIZE)
    arr[0, first_off : first_off + first_n] = buf[:first_n]
    rest = buf[first_n:]
    if rest.size:
        cont_off = info_off + SHARE_INFO_BYTES
        padded = np.zeros(
            (n - 1) * CONTINUATION_SPARSE_SHARE_CONTENT_SIZE, dtype=np.uint8
        )
        padded[: rest.size] = rest
        arr[1:, cont_off : cont_off + CONTINUATION_SPARSE_SHARE_CONTENT_SIZE] = (
            padded.reshape(n - 1, CONTINUATION_SPARSE_SHARE_CONTENT_SIZE)
        )
    return arr


def parse_sparse_shares(shares: Sequence[Share]) -> List[Tuple[Namespace, bytes]]:
    """Reassemble (namespace, blob-bytes) sequences from sparse shares.

    Padding sequences (sequence length 0) are skipped.
    """
    blobs: List[Tuple[Namespace, bytes]] = []
    i = 0
    while i < len(shares):
        sh = shares[i]
        if not sh.is_sequence_start:
            raise ValueError(f"share {i}: expected sequence start")
        seq_len = sh.sequence_len()
        if seq_len == 0:  # padding share
            i += 1
            continue
        ns = sh.namespace
        data = bytearray(sh.sparse_payload())
        i += 1
        while len(data) < seq_len:
            if i >= len(shares):
                raise ValueError("truncated share sequence")
            cont = shares[i]
            if cont.is_sequence_start or cont.namespace.raw != ns.raw:
                raise ValueError(f"share {i}: broken sequence continuation")
            data.extend(cont.sparse_payload())
            i += 1
        blobs.append((ns, bytes(data[:seq_len])))
    return blobs


# ---------------------------------------------------------------------------
# Compact (transaction) shares
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    """Unsigned LEB128 varint (protobuf-style), as used for tx unit delimiters.

    Values are bounded to uint64 — symmetric with :func:`_read_varint`.
    """
    if n < 0 or n >= 1 << 64:
        raise ValueError(f"varint value out of uint64 range: {n}")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    result = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            # minimal-encoding rule (specs/wire.md "Primitives"): a
            # multi-byte varint must not end in a zero group — without
            # this, the same value has many encodings and a signed tx's
            # wire bytes become malleable (sign_bytes covers the
            # verbatim wire slices, SignDoc parity)
            if b == 0 and shift > 0:
                raise ValueError("non-minimal varint encoding")
            if result >= 1 << 64:
                raise ValueError("varint exceeds uint64 range")
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def split_txs_into_shares(namespace: Namespace, txs: Sequence[bytes]) -> List[Share]:
    """Write length-delimited txs into one compact share sequence.

    Reserved bytes hold the absolute in-share index of the first unit that
    starts in that share (0 if none) — specs/shares.md "Transaction Shares".
    """
    units = b"".join(_varint(len(tx)) + tx for tx in txs)
    seq_len = len(units)
    if seq_len == 0:
        return []  # consistent with compact_shares_needed([]) == 0

    # Content capacity per share.
    caps = [FIRST_COMPACT_SHARE_CONTENT_SIZE]
    n_shares = 1
    total = caps[0]
    while total < seq_len:
        caps.append(CONTINUATION_COMPACT_SHARE_CONTENT_SIZE)
        total += CONTINUATION_COMPACT_SHARE_CONTENT_SIZE
        n_shares += 1

    # Absolute content offsets where each unit starts.
    unit_starts = []
    pos = 0
    for tx in txs:
        unit_starts.append(pos)
        pos += len(_varint(len(tx))) + len(tx)

    shares: List[Share] = []
    content_pos = 0
    unit_idx = 0
    for share_i in range(n_shares):
        cap = caps[share_i]
        chunk = units[content_pos : content_pos + cap]
        # First unit starting within [content_pos, content_pos + len(chunk))
        reserved = 0
        while unit_idx < len(unit_starts) and unit_starts[unit_idx] < content_pos:
            unit_idx += 1
        if unit_idx < len(unit_starts) and unit_starts[unit_idx] < content_pos + cap:
            in_share_off = unit_starts[unit_idx] - content_pos
            header = NAMESPACE_SIZE + SHARE_INFO_BYTES + COMPACT_SHARE_RESERVED_BYTES
            if share_i == 0:
                header += SEQUENCE_LEN_BYTES
            reserved = header + in_share_off
        if share_i == 0:
            raw = (
                namespace.raw
                + bytes([_info_byte(DEFAULT_SHARE_VERSION, True)])
                + seq_len.to_bytes(SEQUENCE_LEN_BYTES, "big")
                + reserved.to_bytes(COMPACT_SHARE_RESERVED_BYTES, "big")
                + chunk
            )
        else:
            raw = (
                namespace.raw
                + bytes([_info_byte(DEFAULT_SHARE_VERSION, False)])
                + reserved.to_bytes(COMPACT_SHARE_RESERVED_BYTES, "big")
                + chunk
            )
        shares.append(Share(raw.ljust(SHARE_SIZE, b"\x00")))
        content_pos += cap
    return shares


def parse_compact_shares(shares: Sequence[Share]) -> List[bytes]:
    """Reassemble the length-delimited tx list from a compact share sequence.

    Strict: one sequence, uniform namespace, zero padding beyond the sequence
    length — a malformed square must fail here, not decode loosely.
    """
    if not shares:
        return []
    if not shares[0].is_sequence_start:
        raise ValueError("compact sequence must begin with a sequence-start share")
    ns_raw = shares[0].namespace.raw
    seq_len = shares[0].sequence_len()
    content = bytearray()
    for i, sh in enumerate(shares):
        if i > 0 and sh.is_sequence_start:
            raise ValueError(f"compact share {i}: unexpected second sequence start")
        if sh.namespace.raw != ns_raw:
            raise ValueError(f"compact share {i}: namespace mismatch")
        content.extend(sh.compact_payload())
    if len(content) < seq_len:
        raise ValueError("compact sequence shorter than declared sequence length")
    if any(content[seq_len:]):
        raise ValueError("nonzero padding after compact sequence content")
    content = bytes(content[:seq_len])
    txs: List[bytes] = []
    pos = 0
    while pos < len(content):
        tx_len, pos = _read_varint(content, pos)
        if pos + tx_len > len(content):
            raise ValueError("truncated tx unit")
        txs.append(content[pos : pos + tx_len])
        pos += tx_len
    return txs


def compact_shares_needed(txs: Sequence[bytes]) -> int:
    seq_len = sum(len(_varint(len(t))) + len(t) for t in txs)
    if seq_len == 0:
        return 0
    if seq_len <= FIRST_COMPACT_SHARE_CONTENT_SIZE:
        return 1
    rem = seq_len - FIRST_COMPACT_SHARE_CONTENT_SIZE
    return 1 + -(-rem // CONTINUATION_COMPACT_SHARE_CONTENT_SIZE)


# ---------------------------------------------------------------------------
# Padding shares
# ---------------------------------------------------------------------------


def padding_share(namespace: Namespace) -> Share:
    """A padding share: sequence start, sequence length 0, zero payload."""
    raw = (
        namespace.raw
        + bytes([_info_byte(DEFAULT_SHARE_VERSION, True)])
        + (0).to_bytes(SEQUENCE_LEN_BYTES, "big")
    )
    return Share(raw.ljust(SHARE_SIZE, b"\x00"))


def namespace_padding_shares(namespace: Namespace, n: int) -> List[Share]:
    return [padding_share(namespace) for _ in range(n)]


def reserved_padding_shares(n: int) -> List[Share]:
    return [padding_share(PRIMARY_RESERVED_PADDING_NAMESPACE) for _ in range(n)]


def tail_padding_shares(n: int) -> List[Share]:
    return [padding_share(TAIL_PADDING_NAMESPACE) for _ in range(n)]


# ---------------------------------------------------------------------------
# Device export
# ---------------------------------------------------------------------------


def shares_to_array(shares: Iterable[Share]) -> np.ndarray:
    """Pack shares into a ``uint8[n, 512]`` array for the device pipeline.
    One join + one frombuffer instead of a copy per share (16k shares at
    k=128 made the per-share loop a measurable slice of PrepareProposal)."""
    joined = b"".join(sh.raw for sh in shares)
    out = np.frombuffer(joined, dtype=np.uint8).reshape(-1, SHARE_SIZE)
    return out.copy()  # callers may mutate; frombuffer views are read-only


def array_to_shares(arr: np.ndarray) -> List[Share]:
    if arr.ndim != 2 or arr.shape[1] != SHARE_SIZE or arr.dtype != np.uint8:
        raise ValueError(f"expected uint8[n, {SHARE_SIZE}], got {arr.dtype}{arr.shape}")
    return [Share(arr[i].tobytes()) for i in range(arr.shape[0])]
