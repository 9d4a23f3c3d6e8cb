"""Namespace-scoped share retrieval with trustless completeness.

Role: the `GetSharesByNamespace` API the reference ecosystem's light nodes
use to pull a rollup's data — every share of one namespace, provable both
for INCLUSION (NMT range proofs to the committed row roots) and
COMPLETENESS (the NMT's ordered-namespace property: sibling nodes outside
the returned range carry min/max namespaces that exclude the target, and
rows whose roots exclude the namespace need no proof at all).

The verifier needs only a DAH it has checked against a trusted data root
(`DataAvailabilityHeader.hash`); no share outside the namespace is ever
transferred.

Re-homed from ``celestia_tpu/da/namespace_data.py``: the imports and the
data access differ.  Only the namespaces of the rows whose roots cover the
namespace are copied from the EDS's device; their level stacks are
computed on that device (K2's row-set mode + K3 over the rows, for any
number of rows), and one gather copies out only the proof digests and the
returned shares (K7b, da/proof.py ``row_range_proofs``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch

from celestia_tpu_torch.appconsts import NAMESPACE_SIZE, SHARE_SIZE
from celestia_tpu_torch.da.dah import DataAvailabilityHeader, ExtendedDataSquare
from celestia_tpu_torch.da.namespace import PARITY_SHARE_NAMESPACE
from celestia_tpu_torch.da.proof import NmtRangeProof, row_range_proofs

PARITY_NS = PARITY_SHARE_NAMESPACE.raw


def root_namespace_range(root: bytes) -> Tuple[bytes, bytes]:
    """(min, max) namespace of a 90-byte NMT root digest."""
    return root[:NAMESPACE_SIZE], root[NAMESPACE_SIZE : 2 * NAMESPACE_SIZE]




@dataclass(frozen=True)
class RowNamespaceData:
    row: int
    start: int  # column range within the row's 2k leaves
    end: int
    shares: Tuple[bytes, ...]
    proof: NmtRangeProof
    # absence witness: when the row's root COVERS the namespace but no
    # share carries it, this is the ns-prefixed leaf at `start` whose
    # namespace is the first one above the target (shares empty, end ==
    # start + 1).  Valid blocks have namespace-ordered rows (ProcessProposal
    # rejects unordered squares), so one witness + left-sibling bounds
    # prove the gap — the nmt library's AbsenceProof shape.
    absence_leaf: bytes = b""


@dataclass(frozen=True)
class NamespaceData:
    """All shares of one namespace in a block, with proofs."""

    namespace: bytes
    square_size: int  # original k
    rows: Tuple[RowNamespaceData, ...]

    def blobs_payload(self) -> bytes:
        """The raw concatenated shares (callers parse sequences out of
        them with da.shares.parse_sparse_shares)."""
        return b"".join(s for r in self.rows for s in r.shares)

    def verify(self, dah: DataAvailabilityHeader) -> bool:
        """Verify inclusion AND completeness against a trusted DAH.

        Every row whose root's namespace range covers the target MUST be
        present with a complete range proof; rows whose roots exclude it
        need nothing (their absence is proven by the root itself)."""
        ns = self.namespace
        k = self.square_size
        if len(dah.row_roots) != 2 * k:
            return False
        by_row = {r.row: r for r in self.rows}
        if len(by_row) != len(self.rows):
            return False  # duplicate rows
        # every entry must name a real row — an out-of-range row would be
        # skipped by the root loop below and its shares would flow into
        # blobs_payload() unverified
        if any(not 0 <= r.row < 2 * k for r in self.rows):
            return False
        # rows must come in row order: payload bytes concatenate in tuple
        # order, so a permuted (but individually valid) response would
        # scramble the reassembled blobs
        if list(by_row) != sorted(by_row):
            return False
        for row_idx, root in enumerate(dah.row_roots):
            ns_min, ns_max = root_namespace_range(root)
            covers = ns_min <= ns <= ns_max
            entry = by_row.get(row_idx)
            if not covers:
                if entry is not None:
                    return False  # claimed data in a row that excludes it
                continue
            if entry is None:
                return False  # withheld a row the DAH proves may hold the ns
            if entry.start != entry.proof.start or entry.end != entry.proof.end:
                return False
            if not entry.shares:
                # absence: a single-leaf witness above the namespace, with
                # every left sibling bounded below it
                if entry.end != entry.start + 1 or not entry.absence_leaf:
                    return False
                if entry.absence_leaf[:NAMESPACE_SIZE] <= ns:
                    return False
                if not entry.proof.verify(
                    root, [entry.absence_leaf], 2 * k
                ):
                    return False
                # right siblings are unconstrained for absence (namespace
                # ordering + one above-target witness already close the gap)
                if not entry.proof.sibling_namespace_bounds(
                    2 * k, ns, check_right=False
                ):
                    return False
                continue
            if len(entry.shares) != entry.end - entry.start:
                return False
            if any(len(s) != SHARE_SIZE for s in entry.shares):
                return False
            leaves = [ns + s for s in entry.shares]
            if not entry.proof.verify_complete_namespace(
                root, leaves, 2 * k, ns
            ):
                return False
        return True

    def to_dict(self) -> dict:
        return {
            "namespace": self.namespace.hex(),
            "square_size": self.square_size,
            "rows": [
                {
                    "row": r.row,
                    "start": r.start,
                    "end": r.end,
                    "shares": [s.hex() for s in r.shares],
                    "nodes": [n.hex() for n in r.proof.nodes],
                    "absence_leaf": r.absence_leaf.hex(),
                }
                for r in self.rows
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "NamespaceData":
        return cls(
            namespace=bytes.fromhex(d["namespace"]),
            square_size=int(d["square_size"]),
            rows=tuple(
                RowNamespaceData(
                    row=int(r["row"]),
                    start=int(r["start"]),
                    end=int(r["end"]),
                    shares=tuple(bytes.fromhex(s) for s in r["shares"]),
                    proof=NmtRangeProof(
                        int(r["start"]), int(r["end"]),
                        tuple(bytes.fromhex(n) for n in r["nodes"]),
                    ),
                    absence_leaf=bytes.fromhex(r.get("absence_leaf", "")),
                )
                for r in d["rows"]
            ),
        )


def get_shares_by_namespace(
    eds: ExtendedDataSquare,
    dah: DataAvailabilityHeader,
    namespace: bytes,
) -> NamespaceData:
    """Prover: collect every share of ``namespace`` with row-wise complete
    range proofs.  Rows whose committed roots exclude the namespace are
    skipped — the roots themselves prove the absence."""
    if len(namespace) != NAMESPACE_SIZE:
        raise ValueError(f"namespace must be {NAMESPACE_SIZE} bytes")
    if namespace >= PARITY_NS:
        raise ValueError("the parity namespace is not queryable data")
    k = eds.square_size
    covered = []
    for row_idx in range(2 * k):
        ns_min, ns_max = root_namespace_range(dah.row_roots[row_idx])
        if ns_min <= namespace <= ns_max:
            covered.append(row_idx)
    if not covered:
        return NamespaceData(namespace=namespace, square_size=k, rows=())
    # only the namespaces of the covered rows' first k cells cross from the
    # EDS's device, in one copy
    t = eds.tensor
    idx = torch.tensor(covered, device=t.device)
    ns_of = t[:, :k, :NAMESPACE_SIZE].index_select(0, idx).cpu().numpy()
    # phase 1: classify covered rows (present range vs absence witness)
    plan: List[Tuple[int, int, int, bool]] = []  # (row, start, end, absent)
    for row_idx, row_ns in zip(covered, ns_of):
        # namespaced data lives in Q0 (parity cells carry the parity ns);
        # shares of one namespace are contiguous within a row (square
        # layout orders namespaces)
        cols = [
            c for c in range(k)
            if row_idx < k and row_ns[c].tobytes() == namespace
        ]
        if not cols:
            # root covers the ns but the row holds none of it: absence
            # witness = the first leaf whose namespace exceeds the target
            witness = next(
                (c for c in range(k) if row_ns[c].tobytes() > namespace),
                k,  # everything below target: first parity cell witnesses
            )
            plan.append((row_idx, witness, witness + 1, True))
            continue
        start, end = cols[0], cols[-1] + 1
        if cols != list(range(start, end)):
            raise ValueError(
                f"namespace {namespace.hex()} not contiguous in row {row_idx}"
            )
        plan.append((row_idx, start, end, False))
    # phase 2: one batched level-stack pass over the covered rows on the
    # EDS's device and one gather of the proofs' digests and the range's
    # shares (the witness share for an absent row)
    spans = [(start, end) for _, start, end, _ in plan]
    proofs, shares, _ = row_range_proofs(eds, covered, spans, spans)
    rows: List[RowNamespaceData] = []
    for (row_idx, start, end, absent), proof, got in zip(plan, proofs, shares):
        if absent:
            leaf_prefix = got[0][:NAMESPACE_SIZE] if start < k else PARITY_NS
            rows.append(
                RowNamespaceData(
                    row=row_idx, start=start, end=end, shares=(),
                    proof=proof,
                    absence_leaf=leaf_prefix + got[0],
                )
            )
        else:
            rows.append(
                RowNamespaceData(
                    row=row_idx, start=start, end=end, shares=got, proof=proof,
                )
            )
    return NamespaceData(namespace=namespace, square_size=k, rows=tuple(rows))
