"""Blob share commitments: merkle-mountain-range subtree roots (ADR-013).

Parity with go-square/inclusion.CreateCommitment as used by
x/blob/types/payforblob.go:49-56 (commitment creation) and
x/blob/types/blob_tx.go:98-107 (re-verification in ProcessProposal), and
with pkg/inclusion's commitment-from-EDS path conceptually: a blob's
commitment is the RFC-6962 merkle root over the NMT roots of its aligned
subtrees, whose widths form a merkle mountain range bounded by
SubtreeWidth(blob) — making the commitment independent of the square size
and equal to the subtree roots that appear in the row NMTs.

Subtree NMT roots are computed on the HOST (native C++ when available,
hashlib otherwise): a blob's mountains are tiny trees (<= 64 leaves), and
per-blob device dispatches would cost a round-trip + a shape-specific
compile each — hundreds of them per full-square proposal, dominating
PrepareProposal/ProcessProposal wall time.  The device keeps the big
batched work (the 4k axis trees); commitments are host work.
"""

from __future__ import annotations

from typing import List

import numpy as np

from celestia_tpu_torch.appconsts import (
    DEFAULT_SUBTREE_ROOT_THRESHOLD,
    NAMESPACE_SIZE,
    round_down_power_of_two,
)
from celestia_tpu_torch.da.blob import Blob
from celestia_tpu_torch.da.square import subtree_width
from celestia_tpu_torch.ops import nmt as nmt_ops
from celestia_tpu_torch.utils import native
from celestia_tpu_torch.utils.lru import LruCache


def _commitment_weigher(key, value) -> int:
    """(sha256 digest, threshold) -> 32-byte commitment entries."""
    return len(key[0]) + len(value) + 64


def merkle_mountain_range_sizes(total: int, max_tree_size: int) -> List[int]:
    """Decompose ``total`` leaves into descending power-of-two mountains
    capped at ``max_tree_size``."""
    sizes: List[int] = []
    while total:
        if total >= max_tree_size:
            sizes.append(max_tree_size)
            total -= max_tree_size
        else:
            p = round_down_power_of_two(total)
            sizes.append(p)
            total -= p
    return sizes


def _nmt_root_host(leaves: np.ndarray) -> bytes:
    """Root of one small NMT on the host: native C++ or hashlib."""
    if native.available():
        return native.nmt_root(leaves).tobytes()
    level = [nmt_ops.leaf_digest_np(leaves[i].tobytes()) for i in range(len(leaves))]
    while len(level) > 1:
        level = [
            nmt_ops.combine_digests_np(level[2 * i], level[2 * i + 1])
            for i in range(len(level) // 2)
        ]
    return level[0]


# content-addressed commitment cache: the same blob's commitment is
# recomputed in CheckTx, FilterTxs AND ProcessProposal (the reference
# recomputes it at each of those validation points too); the digest key
# makes a hit deterministic and consensus-safe.  Once shipped as
# an UNLOCKED plain dict mutated from pooled threads (celint rule R1's
# founding true positive); now the unified thread-safe bounded LRU —
# every read/insert is atomic and the eviction loop is gone.
_COMMITMENT_CACHE = LruCache(
    "commitment", 8192, weigher=_commitment_weigher
)


def create_commitment(
    blob: Blob, subtree_root_threshold: int = DEFAULT_SUBTREE_ROOT_THRESHOLD
) -> bytes:
    """32-byte share commitment of a blob."""
    key = _commitment_key(blob, subtree_root_threshold)
    cached = _COMMITMENT_CACHE.get(key)
    if cached is not None:
        return cached

    leaves, sizes = _blob_leaves(blob, subtree_root_threshold)
    if native.available():
        # one native call per blob (subtree roots + RFC-6962 fold inside)
        out = native.create_commitment(leaves, sizes)
    else:
        roots: List[bytes] = []
        offset = 0
        for s in sizes:
            roots.append(_nmt_root_host(leaves[offset : offset + s]))
            offset += s
        out = nmt_ops.rfc6962_root_np(roots).tobytes()
    # concurrent misses on one key race benignly: both compute the SAME
    # bytes (the commitment is a pure function of the key), last put wins
    _COMMITMENT_CACHE.put(key, out)
    return out


def create_commitments(blobs: List[Blob]) -> List[bytes]:
    return [create_commitment(b) for b in blobs]


def _commitment_key(blob: Blob, subtree_root_threshold: int):
    import hashlib

    return (
        hashlib.sha256(
            blob.namespace.raw + (blob.share_version & 0xFF).to_bytes(1, "big")
            + blob.data
        ).digest(),
        subtree_root_threshold,
    )


def _blob_leaves(blob: Blob, subtree_root_threshold: int):
    """(ns-prefixed NMT leaves uint8[n, 541], mountain sizes) for one
    blob — the single construction shared by create_commitment and
    warm_commitments (a consensus value must not have two layouts)."""
    from celestia_tpu_torch.da.shares import blob_shares_array

    arr = blob_shares_array(blob.namespace, blob.data, blob.share_version)
    n = arr.shape[0]
    width = subtree_width(n, subtree_root_threshold)
    sizes = merkle_mountain_range_sizes(n, width)
    # NMT leaves: namespace-prefixed shares (Q0 rule — own namespace).
    ns = np.broadcast_to(
        np.frombuffer(blob.namespace.raw, dtype=np.uint8), (n, NAMESPACE_SIZE)
    )
    leaves = np.ascontiguousarray(np.concatenate([ns, arr], axis=1))
    return leaves, sizes


def warm_commitments(
    blobs: List[Blob],
    subtree_root_threshold: int = DEFAULT_SUBTREE_ROOT_THRESHOLD,
) -> None:
    """Precompute commitments for MANY blobs in ONE native call and fill
    the cache, so the per-blob ``create_commitment`` calls inside tx
    validation all hit.  At proposal scale the per-blob ctypes crossing
    was a visible slice of FilterTxs (512 blobs x ~27 us call overhead);
    the batch shape also lets the C side thread across blobs.  No-op for
    blobs already cached; falls back to nothing (the per-blob path
    handles it) when the native library is absent.  Malformed blobs are
    skipped (best-effort): callers pass unvalidated envelopes, and the
    per-tx validate_blob_tx path reports them."""
    if not native.available():
        return

    pending: List[tuple] = []  # (key, leaves, sizes)
    seen = set()
    for blob in blobs:
        try:
            key = _commitment_key(blob, subtree_root_threshold)
            if key in seen or key in _COMMITMENT_CACHE:
                continue
            seen.add(key)
            leaves, sizes = _blob_leaves(blob, subtree_root_threshold)
        except (ValueError, OverflowError):
            # warming is best-effort over UNVALIDATED blobs: a malformed
            # one (empty data, bad share version) is simply skipped here
            # and reported properly by the per-tx validate_blob_tx path
            continue
        pending.append((key, leaves, sizes))
    if not pending:
        return
    leaves_all = np.ascontiguousarray(
        np.concatenate([p[1] for p in pending], axis=0)
    )
    blob_off = np.cumsum([0] + [p[1].shape[0] for p in pending])
    sizes_all = np.concatenate([p[2] for p in pending]).astype(np.int32)
    size_off = np.cumsum([0] + [len(p[2]) for p in pending])
    out = native.create_commitments_batch(
        leaves_all, blob_off, sizes_all, size_off
    )
    for i, (key, _, _) in enumerate(pending):
        _COMMITMENT_CACHE.put(key, out[i].tobytes())
