"""Blob, BlobTx envelope and IndexWrapper — the tx-side containers of blobs.

Behavioral parity with go-square/blob as used by the reference
(app/check_tx.go:19, x/blob/types/blob_tx.go).  The wire
formats here are this framework's own deterministic binary encodings (the
reference uses protobuf); the semantics match:

* ``BlobTx``     — envelope carrying a signed PayForBlobs tx plus its blobs;
                   this is what travels in the mempool and in block data.
* ``IndexWrapper`` — a PFB tx annotated with the share indexes where its blobs
                   start; this is what is written into the square's
                   PAY_FOR_BLOB namespace (app/encoding/index_wrapper_decoder.go).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from celestia_tpu_torch.appconsts import DEFAULT_SHARE_VERSION, NAMESPACE_SIZE
from celestia_tpu_torch.da.namespace import Namespace
from celestia_tpu_torch.da.shares import _read_varint, _varint, sparse_shares_needed

_BLOB_TX_MAGIC = b"CTPUBLB0"
_INDEX_WRAPPER_MAGIC = b"CTPUIDX0"


@dataclass(frozen=True)
class Blob:
    namespace: Namespace
    data: bytes
    share_version: int = DEFAULT_SHARE_VERSION

    def shares_needed(self) -> int:
        return sparse_shares_needed(len(self.data))


@dataclass(frozen=True)
class BlobTx:
    """A signed PFB transaction together with the blobs it pays for."""

    tx: bytes
    blobs: Tuple[Blob, ...]

    def marshal(self) -> bytes:
        out = bytearray(_BLOB_TX_MAGIC)
        out += _varint(len(self.tx))
        out += self.tx
        out += _varint(len(self.blobs))
        for b in self.blobs:
            out += b.namespace.raw
            out += _varint(b.share_version)
            out += _varint(len(b.data))
            out += b.data
        return bytes(out)


def is_blob_tx(raw: bytes) -> bool:
    return raw.startswith(_BLOB_TX_MAGIC)


def unmarshal_blob_tx(raw: bytes) -> Optional[BlobTx]:
    """Parse a BlobTx envelope; None if ``raw`` is not one."""
    if not is_blob_tx(raw):
        return None
    pos = len(_BLOB_TX_MAGIC)
    try:
        tx_len, pos = _read_varint(raw, pos)
        tx = raw[pos : pos + tx_len]
        if len(tx) != tx_len:
            return None
        pos += tx_len
        n_blobs, pos = _read_varint(raw, pos)
        blobs: List[Blob] = []
        for _ in range(n_blobs):
            ns = Namespace(raw[pos : pos + NAMESPACE_SIZE])
            pos += NAMESPACE_SIZE
            sv, pos = _read_varint(raw, pos)
            dlen, pos = _read_varint(raw, pos)
            data = raw[pos : pos + dlen]
            if len(data) != dlen:
                return None
            pos += dlen
            blobs.append(Blob(ns, data, sv))
        if pos != len(raw):
            return None
        return BlobTx(tx, tuple(blobs))
    except (ValueError, IndexError):
        return None


@dataclass(frozen=True)
class IndexWrapper:
    """PFB tx + share indexes of its blobs, as laid out in the square."""

    tx: bytes
    share_indexes: Tuple[int, ...]

    def marshal(self) -> bytes:
        out = bytearray(_INDEX_WRAPPER_MAGIC)
        out += _varint(len(self.tx))
        out += self.tx
        out += _varint(len(self.share_indexes))
        for idx in self.share_indexes:
            out += int(idx).to_bytes(4, "big")
        return bytes(out)

    @staticmethod
    def marshalled_size(tx_len: int, n_blobs: int) -> int:
        """Size of the wrapper before indexes are known (indexes are fixed 4B)."""
        return (
            len(_INDEX_WRAPPER_MAGIC)
            + len(_varint(tx_len))
            + tx_len
            + len(_varint(n_blobs))
            + 4 * n_blobs
        )


def is_index_wrapper(raw: bytes) -> bool:
    return raw.startswith(_INDEX_WRAPPER_MAGIC)


def unmarshal_index_wrapper(raw: bytes) -> Optional[IndexWrapper]:
    if not is_index_wrapper(raw):
        return None
    pos = len(_INDEX_WRAPPER_MAGIC)
    try:
        tx_len, pos = _read_varint(raw, pos)
        tx = raw[pos : pos + tx_len]
        if len(tx) != tx_len:
            return None
        pos += tx_len
        n, pos = _read_varint(raw, pos)
        idxs = []
        for _ in range(n):
            idxs.append(int.from_bytes(raw[pos : pos + 4], "big"))
            pos += 4
        if pos != len(raw):
            return None
        return IndexWrapper(tx, tuple(idxs))
    except (ValueError, IndexError):
        return None
