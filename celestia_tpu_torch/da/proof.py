"""Inclusion proofs: NMT range proofs + merkle proofs to the data root.

Parity with the reference's pkg/proof/: NewTxInclusionProof (proof.go:20-42),
NewShareInclusionProof (proof.go:55-167) and their verification — proving
that a range of shares (or a tx's compact shares) is committed by the
block's data root.  A share proof is: for each row the range touches, an NMT
range proof of those shares against the row root, plus an RFC-6962 merkle
proof of each row root against the data root (over the 4k row+col roots).

Proof generation reads the device-computed NMT level stack (ops/nmt.py
row_level_stack); verification is host-side hashlib (proofs are verified by
light clients, not validators).

Re-homed from ``celestia_tpu/da/proof.py``; only the imports and the
device leg of :func:`new_share_inclusion_proof` differ.  There the touched
rows are sliced from the EDS on its device, their level stacks computed
there (K2's row-set mode + K3 over the rows, :func:`row_range_proofs`),
the root aunts read from the block's root tree on that device (the cached
entry's, else one K4 launch over the DAH's roots), and one K7b
``das_proof_gather`` launch copies out only the sibling digests, shares
and aunts that go into the proof, fetched with one copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from celestia_tpu_torch.appconsts import (
    CONTINUATION_COMPACT_SHARE_CONTENT_SIZE,
    FIRST_COMPACT_SHARE_CONTENT_SIZE,
    NAMESPACE_SIZE,
    SHARE_SIZE,
)
from celestia_tpu_torch.da import device_plane
from celestia_tpu_torch.da.dah import DataAvailabilityHeader, ExtendedDataSquare
from celestia_tpu_torch.da.namespace import TRANSACTION_NAMESPACE, Namespace
from celestia_tpu_torch.da.shares import _varint
from celestia_tpu_torch.da.square import Square
from celestia_tpu_torch.ops import gather
from celestia_tpu_torch.ops import nmt as nmt_ops


# ---------------------------------------------------------------------------
# NMT range proofs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NmtRangeProof:
    """Proof that leaves [start, end) belong to an NMT with a given root."""

    start: int
    end: int
    nodes: Tuple[bytes, ...]  # sibling digests, traversal order

    def verify(
        self, root: bytes, leaves: Sequence[bytes], tree_size: int
    ) -> bool:
        """Recompute the root from the namespace-prefixed leaves + siblings.

        ``leaves`` are the ns-prefixed leaf payloads for [start, end).
        """
        if not 0 <= self.start < self.end <= tree_size:
            return False
        if len(leaves) != self.end - self.start:
            return False
        nodes = list(self.nodes)
        leaf_digests = [nmt_ops.leaf_digest_np(l) for l in leaves]

        def compute(lo: int, hi: int) -> Optional[bytes]:
            if lo >= self.end or hi <= self.start:  # disjoint: sibling node
                if not nodes:
                    return None
                return nodes.pop(0)
            if hi - lo == 1:
                return leaf_digests[lo - self.start]
            mid = (lo + hi) // 2
            l = compute(lo, mid)
            r = compute(mid, hi)
            if l is None or r is None:
                return None
            return nmt_ops.combine_digests_np(l, r)

        got = compute(0, tree_size)
        return got == root and not nodes

    def sibling_namespace_bounds(
        self, tree_size: int, namespace: bytes, check_right: bool = True
    ) -> bool:
        """Walk the proof's sibling digests in the SAME traversal order
        verify() consumes them and check their embedded namespace ranges
        against the target: every left sibling must end below it, and
        (when ``check_right``) every right sibling must start above it.
        The single source of truth for sibling ordering — completeness and
        absence verification both ride on it."""
        nodes = list(self.nodes)

        def walk(lo: int, hi: int) -> bool:
            if lo >= self.end or hi <= self.start:
                node = nodes.pop(0)
                if hi <= self.start:  # entirely left of the range
                    return node[NAMESPACE_SIZE : 2 * NAMESPACE_SIZE] < namespace
                if check_right:  # entirely right
                    return node[:NAMESPACE_SIZE] > namespace
                return True
            if hi - lo == 1:
                return True
            mid = (lo + hi) // 2
            return walk(lo, mid) and walk(mid, hi)

        return walk(0, tree_size)

    def verify_complete_namespace(
        self, root: bytes, leaves: Sequence[bytes], tree_size: int,
        namespace: bytes,
    ) -> bool:
        """Verify the range AND that it covers every leaf of ``namespace``
        in the tree: each sibling subtree left of the range must end below
        the namespace, each right sibling must start above it (their
        min/max namespaces are embedded in the 90-byte digests — the NMT
        property that makes per-namespace retrieval trustlessly complete)."""
        if not self.verify(root, leaves, tree_size):
            return False
        for l in leaves:
            if l[:NAMESPACE_SIZE] != namespace:
                return False  # foreign leaf smuggled into the range
        return self.sibling_namespace_bounds(tree_size, namespace)


def range_node_indices(n: int, start: int, end: int, n_levels: int) -> List[Tuple[int, int]]:
    """(level, index) of every sibling digest of the range proof [start,
    end) in a tree of n leaves, in the order the proof records them."""
    out: List[Tuple[int, int]] = []

    def walk(lo: int, hi: int, level: int):
        if lo >= end or hi <= start:
            # disjoint aligned span: one sibling digest from the stack
            out.append((level, lo >> level))
            return
        if hi - lo == 1:
            return  # in-range leaf, provided by the verifier
        mid = (lo + hi) // 2
        walk(lo, mid, level - 1)
        walk(mid, hi, level - 1)

    walk(0, n, n_levels - 1)
    return out


def nmt_range_proof_from_levels(
    levels: List[np.ndarray], start: int, end: int
) -> NmtRangeProof:
    """Build a range proof from a tree's level stack (device output).

    levels[0] = leaf digests (n, 90), levels[-1] = root (1, 90).
    """
    n = levels[0].shape[0]
    nodes = tuple(
        levels[level][idx].tobytes()
        for level, idx in range_node_indices(n, start, end, len(levels))
    )
    return NmtRangeProof(start, end, nodes)


def row_range_proofs(
    eds: ExtendedDataSquare,
    rows: Sequence[int],
    ranges: Sequence[Tuple[int, int]],
    share_ranges: Sequence[Tuple[int, int]] = (),
    dah: Optional[DataAvailabilityHeader] = None,
) -> Tuple[List[NmtRangeProof], List[Tuple[bytes, ...]], List["MerkleProof"]]:
    """Range proofs of ``ranges[i]`` within row tree ``rows[i]``, computed
    on the EDS's device: the rows are gathered into a block there, their
    level stacks hashed from it with one K2 launch in its row-set mode and
    one K3 launch for every level over all rows
    (:func:`nmt_ops.row_level_stack`), and one K7b launch
    gathers the proofs' sibling digests, for each ``share_ranges[i]``
    given the shares of that column range of row ``rows[i]``, and, when
    ``dah`` is given, each row root's aunts in the block's root tree
    (``device_plane.root_tree``: the cached entry's, else one K4 launch over
    the DAH's roots).  One copy brings them to the host.  Returns (proofs,
    shares per row, root proofs -- empty without ``dah``)."""
    block, _ = nmt_ops.eds_rows(eds.tensor, rows)  # only these rows are copied
    n2 = eds.width
    levels = nmt_ops.row_level_stack(block, rows)
    L = len(levels)
    sources = device_plane.nmt_sources(levels) + [device_plane.eds_source(block)]
    aunts = (2 * n2).bit_length() - 1 if dah is not None else 0  # log2(4k)
    if aunts:
        sources += device_plane.root_sources(device_plane.root_tree(dah, block.device))
    # the shares, then the aunts, then the digests: the shares and the
    # hashes start on 16-byte boundaries, which K7b copies as 16-byte words
    items: List[Tuple[int, int, int, int]] = []
    off = 0
    for i, (c0, c1) in enumerate(share_ranges):
        for c in range(c0, c1):
            items.append((L, i, c, off))
            off += SHARE_SIZE
    for row in rows if aunts else ():
        for j in range(aunts):
            items.append((L + 1 + j, 0, (row >> j) ^ 1, off))
            off += 32
    node_counts = []
    for i, (start, end) in enumerate(ranges):
        nodes = range_node_indices(n2, start, end, L)
        node_counts.append(len(nodes))
        for level, idx in nodes:
            items.append((level, i, idx, off))
            off += nmt_ops.NMT_DIGEST_SIZE
    table = np.array(items, dtype=np.int32).reshape(-1, 4)
    raw = gather.das_proof_gather(sources, table, off).cpu().numpy().tobytes()
    d, pos = nmt_ops.NMT_DIGEST_SIZE, 0
    shares = []
    for c0, c1 in share_ranges:
        shares.append(tuple(
            raw[pos + j * SHARE_SIZE : pos + (j + 1) * SHARE_SIZE] for j in range(c1 - c0)
        ))
        pos += (c1 - c0) * SHARE_SIZE
    root_proofs = []
    for row in rows if aunts else ():
        root_proofs.append(MerkleProof(
            row, 2 * n2, tuple(raw[pos + j * 32 : pos + (j + 1) * 32] for j in range(aunts))
        ))
        pos += aunts * 32
    proofs = []
    for (start, end), count in zip(ranges, node_counts):
        proofs.append(NmtRangeProof(
            start, end, tuple(raw[pos + j * d : pos + (j + 1) * d] for j in range(count))
        ))
        pos += count * d
    return proofs, shares, root_proofs


# ---------------------------------------------------------------------------
# RFC-6962 merkle proofs (tendermint split rule) for the data root
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MerkleProof:
    index: int
    total: int
    aunts: Tuple[bytes, ...]  # bottom-up sibling hashes

    def verify(self, root: bytes, leaf: bytes) -> bool:
        import hashlib

        if not 0 <= self.index < self.total:
            return False
        h = hashlib.sha256(b"\x00" + leaf).digest()
        idx, total = self.index, self.total
        aunts = list(self.aunts)

        def rec(h, idx, total, aunts):
            import hashlib

            if total == 1:
                return h if not aunts else None
            split = 1
            while split * 2 < total:
                split *= 2
            if not aunts:
                return None
            aunt = aunts.pop()
            if idx < split:
                left = rec(h, idx, split, aunts)
                if left is None:
                    return None
                return hashlib.sha256(b"\x01" + left + aunt).digest()
            right = rec(h, idx - split, total - split, aunts)
            if right is None:
                return None
            return hashlib.sha256(b"\x01" + aunt + right).digest()

        # aunts are stored bottom-up; rec consumes from the END (top-down)
        got = rec(h, idx, total, aunts)
        return got == root and not aunts


def merkle_level_tree(leaves: Sequence[bytes]) -> List[np.ndarray]:
    """All levels of the RFC-6962 tree over a POWER-OF-TWO number of
    equal-length leaves: ``[leaf hashes (n, 32), (n/2, 32), ..., root
    (1, 32)]``, hashed through the threaded host batch kernel.

    For power-of-two counts the tendermint split rule (largest power of
    two strictly below n) degenerates to n/2 at every level, so the tree
    is perfectly balanced and the proof for ANY index is a pure
    level-stack extraction (:func:`merkle_proof_from_levels`) — the DAS
    serving plane builds this ONCE per block over the DAH's 4k axis
    roots instead of re-hashing the whole tree per sampled cell.
    Byte-identical to :func:`merkle_proof` (pinned by tests/test_das.py).
    """
    from celestia_tpu_torch.ops.sha256 import sha256_batch_host

    n = len(leaves)
    if n == 0 or n & (n - 1):
        raise ValueError(f"leaf count must be a power of two, got {n}")
    arr = np.frombuffer(b"".join(leaves), dtype=np.uint8).reshape(n, -1)
    zero = np.zeros((n, 1), dtype=np.uint8)
    levels = [sha256_batch_host(np.concatenate([zero, arr], axis=-1))]
    while levels[-1].shape[0] > 1:
        cur = levels[-1]
        left, right = cur[0::2], cur[1::2]
        one = np.ones((left.shape[0], 1), dtype=np.uint8)
        levels.append(
            sha256_batch_host(np.concatenate([one, left, right], axis=-1))
        )
    for lv in levels:
        lv.flags.writeable = False  # served from a shared cache
    return levels


def merkle_proof_from_levels(
    levels: List[np.ndarray], index: int
) -> MerkleProof:
    """Extract the proof for ``index`` from a :func:`merkle_level_tree`
    stack: the level-``j`` aunt is the sibling subtree hash
    ``levels[j][(index >> j) ^ 1]`` (aunts stored bottom-up, exactly the
    order :func:`merkle_proof` records them in)."""
    total = levels[0].shape[0]
    if not 0 <= index < total:
        raise ValueError(f"index {index} out of range for {total} leaves")
    aunts = tuple(
        levels[j][(index >> j) ^ 1].tobytes() for j in range(len(levels) - 1)
    )
    return MerkleProof(index, total, aunts)


def merkle_proof(leaves: Sequence[bytes], index: int) -> MerkleProof:
    """Proof for leaf ``index`` over arbitrary-count leaves (tendermint
    simple merkle, split = largest power of two < n)."""
    import hashlib

    aunts: List[bytes] = []

    def rec(items: List[bytes], idx: int) -> bytes:
        if len(items) == 1:
            return hashlib.sha256(b"\x00" + items[0]).digest()
        split = 1
        while split * 2 < len(items):
            split *= 2
        if idx < split:
            h = rec(items[:split], idx)
            other = _subtree_hash(items[split:])
        else:
            h = rec(items[split:], idx - split)
            other = _subtree_hash(items[:split])
        aunts.append(other)
        return h  # unused

    def _subtree_hash(items: List[bytes]) -> bytes:
        return bytes(nmt_ops.rfc6962_root_np(items))

    rec(list(leaves), index)
    return MerkleProof(index, len(leaves), tuple(aunts))


# ---------------------------------------------------------------------------
# Share / tx inclusion proofs (pkg/proof parity)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RowShareProof:
    row: int  # EDS row index
    start_col: int
    end_col: int
    nmt_proof: NmtRangeProof
    root_proof: MerkleProof  # row root -> data root


@dataclass(frozen=True)
class ShareInclusionProof:
    """Proof that shares [start, end) of the ORIGINAL square are committed
    by the data root (NewShareInclusionProof, proof.go:55-167)."""

    start: int
    end: int
    square_size: int
    namespace: bytes
    shares: Tuple[bytes, ...]  # the raw 512-B shares being proven
    row_proofs: Tuple[RowShareProof, ...]
    row_roots: Tuple[bytes, ...]

    def verify(self, data_root: bytes) -> bool:
        k = self.square_size
        if not 0 <= self.start < self.end <= k * k:
            return False
        # The row proofs must cover EXACTLY the declared [start, end) range:
        # contiguous rows, correct column slices, row-root merkle indexes
        # bound to those rows (over the 4k row+col roots).  Without this
        # binding a prover could present valid shares from different
        # positions than claimed.
        first_row, last_row = self.start // k, (self.end - 1) // k
        expected_rows = list(range(first_row, last_row + 1))
        if len(self.row_proofs) != len(expected_rows):
            return False
        if len(self.row_roots) != len(self.row_proofs):
            return False
        share_i = 0
        for rp, root, row in zip(self.row_proofs, self.row_roots, expected_rows):
            if rp.row != row:
                return False
            want_c0 = self.start - row * k if row == first_row else 0
            want_c1 = self.end - row * k if row == last_row else k
            if (rp.start_col, rp.end_col) != (want_c0, want_c1):
                return False
            if (rp.nmt_proof.start, rp.nmt_proof.end) != (want_c0, want_c1):
                return False
            if rp.root_proof.index != row or rp.root_proof.total != 4 * k:
                return False
            n_shares = rp.end_col - rp.start_col
            row_shares = self.shares[share_i : share_i + n_shares]
            if len(row_shares) != n_shares:
                return False
            share_i += n_shares
            # ns-prefixed leaves (Q0 rule: own namespace)
            leaves = [s[:NAMESPACE_SIZE] + s for s in row_shares]
            if not rp.nmt_proof.verify(root, leaves, 2 * k):
                return False
            if not rp.root_proof.verify(data_root, root):
                return False
        return share_i == len(self.shares)

    # -- wire form (JSON-safe dict) — lets the node API serve proofs
    #    (pkg/proof/querier.go routes) and clients re-verify them --------

    def to_dict(self) -> dict:
        return {
            "start": self.start,
            "end": self.end,
            "square_size": self.square_size,
            "namespace": self.namespace.hex(),
            "shares": [s.hex() for s in self.shares],
            "row_roots": [r.hex() for r in self.row_roots],
            "row_proofs": [
                {
                    "row": rp.row,
                    "start_col": rp.start_col,
                    "end_col": rp.end_col,
                    "nmt": {
                        "start": rp.nmt_proof.start,
                        "end": rp.nmt_proof.end,
                        "nodes": [n.hex() for n in rp.nmt_proof.nodes],
                    },
                    "root": {
                        "index": rp.root_proof.index,
                        "total": rp.root_proof.total,
                        "aunts": [a.hex() for a in rp.root_proof.aunts],
                    },
                }
                for rp in self.row_proofs
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ShareInclusionProof":
        return cls(
            start=int(d["start"]),
            end=int(d["end"]),
            square_size=int(d["square_size"]),
            namespace=bytes.fromhex(d["namespace"]),
            shares=tuple(bytes.fromhex(s) for s in d["shares"]),
            row_proofs=tuple(
                RowShareProof(
                    row=int(rp["row"]),
                    start_col=int(rp["start_col"]),
                    end_col=int(rp["end_col"]),
                    nmt_proof=NmtRangeProof(
                        start=int(rp["nmt"]["start"]),
                        end=int(rp["nmt"]["end"]),
                        nodes=tuple(
                            bytes.fromhex(n) for n in rp["nmt"]["nodes"]
                        ),
                    ),
                    root_proof=MerkleProof(
                        index=int(rp["root"]["index"]),
                        total=int(rp["root"]["total"]),
                        aunts=tuple(
                            bytes.fromhex(a) for a in rp["root"]["aunts"]
                        ),
                    ),
                )
                for rp in d["row_proofs"]
            ),
            row_roots=tuple(bytes.fromhex(r) for r in d["row_roots"]),
        )


def new_share_inclusion_proof(
    eds: ExtendedDataSquare,
    dah: DataAvailabilityHeader,
    start: int,
    end: int,
) -> ShareInclusionProof:
    """Prove original-square shares [start, end) to the data root."""
    k = eds.square_size
    if not 0 <= start < end <= k * k:
        raise ValueError(f"share range [{start}, {end}) out of square bounds")
    shares: List[bytes] = []
    row_proofs: List[RowShareProof] = []
    row_roots: List[bytes] = []
    first_row, last_row = start // k, (end - 1) // k
    # One batched level-stack computation over all touched rows, sliced on
    # the EDS's device (leaf/combine kernels are batch-aware over leading
    # dims): log2(2k) + 1 launches in total instead of rows * log2(2k), and
    # one gather + fetch of only the siblings, shares and root aunts of
    # the proof.
    rows = list(range(first_row, last_row + 1))
    ranges = [
        (start - row * k if row == first_row else 0, end - row * k if row == last_row else k)
        for row in rows
    ]
    nmt_proofs, row_shares, root_proofs = row_range_proofs(eds, rows, ranges, ranges, dah)
    for row, (c0, c1), nmt_proof, got, root_proof in zip(
        rows, ranges, nmt_proofs, row_shares, root_proofs
    ):
        shares.extend(got)
        row_proofs.append(RowShareProof(row, c0, c1, nmt_proof, root_proof))
        row_roots.append(dah.row_roots[row])
    ns = Namespace(shares[0][:NAMESPACE_SIZE]) if shares else TRANSACTION_NAMESPACE
    return ShareInclusionProof(
        start, end, k, ns.raw, tuple(shares), tuple(row_proofs), tuple(row_roots)
    )


# --- tx -> share range (go-square Builder.FindTxShareRange parity) ----------


def _compact_offset_to_share(off: int) -> int:
    if off < FIRST_COMPACT_SHARE_CONTENT_SIZE:
        return 0
    return 1 + (off - FIRST_COMPACT_SHARE_CONTENT_SIZE) // CONTINUATION_COMPACT_SHARE_CONTENT_SIZE


def tx_share_range(
    normal_txs: Sequence[bytes], wrapped_pfbs: Sequence[bytes], tx_index: int
) -> Tuple[int, int]:
    """Share range (in square coordinates) occupied by block tx
    ``tx_index`` — normal txs first (TX namespace), then wrapped PFB txs
    (PFB namespace, offset by the TX-namespace share count)."""
    from celestia_tpu_torch.da.shares import compact_shares_needed

    n_tx_shares = compact_shares_needed(normal_txs)
    if tx_index < len(normal_txs):
        seq, idx, base = normal_txs, tx_index, 0
    else:
        seq, idx, base = wrapped_pfbs, tx_index - len(normal_txs), n_tx_shares
        if idx >= len(wrapped_pfbs):
            raise IndexError(f"tx index {tx_index} out of range")
    off = 0
    for i, t in enumerate(seq):
        unit = len(_varint(len(t))) + len(t)
        if i == idx:
            return base + _compact_offset_to_share(off), base + _compact_offset_to_share(
                off + unit - 1
            ) + 1
        off += unit
    raise IndexError(f"tx index {tx_index} out of range")


def new_tx_inclusion_proof(
    square: Square,
    eds: ExtendedDataSquare,
    dah: DataAvailabilityHeader,
    normal_txs: Sequence[bytes],
    wrapped_pfbs: Sequence[bytes],
    tx_index: int,
) -> ShareInclusionProof:
    """NewTxInclusionProof parity (proof.go:20-42): prove the compact shares
    containing block tx ``tx_index``."""
    start, end = tx_share_range(normal_txs, wrapped_pfbs, tx_index)
    return new_share_inclusion_proof(eds, dah, start, end)
