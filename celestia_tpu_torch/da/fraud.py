"""Bad-encoding fraud proofs (BEFP): disprove a maliciously-encoded square.

Role: the fraud-proof half of the availability story (reference spec
`specs/src/specs/fraud_proofs.md`): if a proposer commits DAH roots over a
square that is NOT a Reed-Solomon codeword, any full node that notices can
produce a compact proof that convinces a light client to reject the header
— k shares of the broken axis, each proven against the ORTHOGONAL axis's
committed root, whose RS completion hashes to a different root than the
one committed for the broken axis.

Soundness: the k shares are pinned by NMT proofs to roots inside the same
DAH the light client already holds, and RS decoding from ANY k points of a
codeword reproduces the codeword — so if the recomputed axis root differs
from the committed one, the committed axis cannot be a codeword, no matter
which k positions the prover picked.

Re-homed from ``celestia_tpu/da/fraud.py``.  :class:`BadEncodingProof`
and its ``verify`` (a light client's check of k shares off the wire) stay
on the host, as there.  :func:`detect_bad_encoding` and :func:`build_befp`
run on the EDS's device: detection decodes every axis of both orientations
from its first k cells (K8a once, K8b per orientation into a scratch copy)
and flags the cells that differ from the committed ones (K8c); the proof's
orthogonal trees are built and read there (``proof.row_range_proofs``:
K2's row-set mode + K3 over the k trees, one K7b gather).  On the CPU the
plain versions run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from celestia_tpu_torch.appconsts import NAMESPACE_SIZE, SHARE_SIZE
from celestia_tpu_torch.da.dah import (
    DataAvailabilityHeader,
    ExtendedDataSquare,
    _writable,
)
from celestia_tpu_torch.da.das import _host_level_stack
from celestia_tpu_torch.da.namespace import PARITY_SHARE_NAMESPACE
from celestia_tpu_torch.da.proof import NmtRangeProof, row_range_proofs
from celestia_tpu_torch.ops import gf256
from celestia_tpu_torch.ops import rs
from celestia_tpu_torch.utils.device import resolve_device

_PARITY_NS = PARITY_SHARE_NAMESPACE.raw

AXIS_ROW = "row"
AXIS_COL = "col"


def _cell_prefix(row: int, col: int, k: int, share: bytes) -> bytes:
    """Q0 cells keep their own namespace; parity cells get the parity
    namespace (the wrapper Push rule both axis trees share)."""
    if row < k and col < k:
        return share[:NAMESPACE_SIZE]
    return _PARITY_NS


def _axis_leaves(cells: np.ndarray, axis: str, index: int, k: int) -> np.ndarray:
    """NMT leaves of one full axis given its 2k cells."""
    n = 2 * k
    out = np.empty((n, NAMESPACE_SIZE + SHARE_SIZE), dtype=np.uint8)
    for j in range(n):
        r, c = (index, j) if axis == AXIS_ROW else (j, index)
        share = cells[j].tobytes()
        out[j, :NAMESPACE_SIZE] = np.frombuffer(
            _cell_prefix(r, c, k, share), dtype=np.uint8
        )
        out[j, NAMESPACE_SIZE:] = cells[j]
    return out


def _axis_root(cells: np.ndarray, axis: str, index: int, k: int) -> bytes:
    levels = _host_level_stack(_axis_leaves(cells, axis, index, k))
    return levels[-1][0].tobytes()


@dataclass(frozen=True)
class BadEncodingProof:
    """Proof that the committed axis `index` is not an RS codeword."""

    axis: str  # AXIS_ROW / AXIS_COL
    index: int
    square_size: int  # original k
    positions: Tuple[int, ...]  # k distinct positions along the axis
    shares: Tuple[bytes, ...]  # the committed cells at those positions
    # share i proven at leaf `index` of the ORTHOGONAL tree positions[i]
    proofs: Tuple[NmtRangeProof, ...]

    def verify(self, dah: DataAvailabilityHeader) -> bool:
        """True iff the fraud is PROVEN against this DAH (a True result
        means the header must be rejected)."""
        k = self.square_size
        n = 2 * k
        if self.axis not in (AXIS_ROW, AXIS_COL):
            return False
        if not 0 <= self.index < n:
            return False
        if len(dah.row_roots) != n or len(dah.col_roots) != n:
            return False
        if len(self.positions) != k or len(set(self.positions)) != k:
            return False
        if len(self.shares) != k or len(self.proofs) != k:
            return False
        if any(len(s) != SHARE_SIZE for s in self.shares):
            return False
        orth_roots = (
            dah.col_roots if self.axis == AXIS_ROW else dah.row_roots
        )
        for pos, share, proof in zip(self.positions, self.shares, self.proofs):
            if not 0 <= pos < n:
                return False
            # cell (index, pos) for a row sits at leaf `index` of column
            # pos's tree (and symmetrically for columns)
            if proof.start != self.index or proof.end != self.index + 1:
                return False
            r, c = (
                (self.index, pos) if self.axis == AXIS_ROW else (pos, self.index)
            )
            leaf = _cell_prefix(r, c, k, share) + share
            if not proof.verify(orth_roots[pos], [leaf], n):
                return False
        # reconstruct the full axis from the k proven cells
        D = gf256.decode_matrices_batch(
            np.asarray([self.positions], dtype=np.uint8), k
        )[0]  # (2k, k)
        X = np.frombuffer(b"".join(self.shares), dtype=np.uint8).reshape(
            k, SHARE_SIZE
        )
        full = gf256.gf_matmul(D, X)
        committed_root = (
            dah.row_roots[self.index]
            if self.axis == AXIS_ROW
            else dah.col_roots[self.index]
        )
        recomputed = _axis_root(full, self.axis, self.index, k)
        return recomputed != committed_root

    def to_dict(self) -> dict:
        return {
            "axis": self.axis,
            "index": self.index,
            "square_size": self.square_size,
            "positions": list(self.positions),
            "shares": [s.hex() for s in self.shares],
            "proofs": [
                {"start": p.start, "end": p.end,
                 "nodes": [x.hex() for x in p.nodes]}
                for p in self.proofs
            ],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BadEncodingProof":
        return cls(
            axis=d["axis"],
            index=int(d["index"]),
            square_size=int(d["square_size"]),
            positions=tuple(int(p) for p in d["positions"]),
            shares=tuple(bytes.fromhex(s) for s in d["shares"]),
            proofs=tuple(
                NmtRangeProof(
                    int(p["start"]), int(p["end"]),
                    tuple(bytes.fromhex(x) for x in p["nodes"]),
                )
                for p in d["proofs"]
            ),
        )


def _eds_tensor(eds_shares, device) -> torch.Tensor:
    """The EDS where it lies (a tensor, or an ExtendedDataSquare's), else a
    numpy EDS uploaded to ``device`` (None: the card)."""
    if isinstance(eds_shares, ExtendedDataSquare):
        return eds_shares.tensor
    if isinstance(eds_shares, torch.Tensor):
        return eds_shares
    return torch.from_numpy(_writable(eds_shares)).to(resolve_device(device))


def detect_bad_encoding(eds_shares, device=None) -> Optional[Tuple[str, int]]:
    """Full-node detection: find an axis whose committed cells are not an
    RS codeword (reconstructing from its first k cells disagrees with the
    rest).  Returns (axis, index) or None for an honestly-encoded square.

    Operates on the shares alone — codeword-ness is a property of the
    square; the DAH only enters when a BEFP is VERIFIED against it.  Runs
    on the EDS's device: one decode-matrix launch (known = the first k
    positions of every axis), then per orientation a decode of every axis
    into one scratch copy and a per-cell comparison with the committed
    square; the answer is the first flagged row, else the first flagged
    column, the order of the JAX loop."""
    eds = _eds_tensor(eds_shares, device).contiguous()
    n = eds.shape[0]
    k = n // 2
    codec = gf256.active_codec()
    dev = eds.device
    known = torch.arange(k, dtype=torch.uint8, device=dev).expand(n, k).contiguous()
    axes = torch.arange(n, dtype=torch.int32, device=dev)
    D = rs.decode_matrices(known, k, codec)
    none = torch.zeros((n, n), dtype=torch.uint8, device=dev)
    scratch = eds.clone()
    flags = []
    for cols in (False, True):
        if cols:  # the row pass overwrote Q1, which the column pass reads
            scratch[:k, k:] = eds[:k, k:]
        decoded = rs.decode_axes(scratch, D, known, axes, cols, codec)
        mismatch, _ = rs.repair_verdicts(decoded, eds, eds, none)
        flags.append(mismatch.to(torch.bool).any(dim=0 if cols else 1))
    flagged = torch.stack(flags).cpu().numpy()  # [orientation, axis]
    for axis, row in zip((AXIS_ROW, AXIS_COL), flagged):
        hit = np.nonzero(row)[0]
        if len(hit):
            return axis, int(hit[0])
    return None


def build_befp(
    eds_shares,
    axis: str,
    index: int,
    positions: Optional[Tuple[int, ...]] = None,
    device=None,
) -> BadEncodingProof:
    """Prover: package k cells of the broken axis with proofs computed
    from the square itself (they bind to whatever DAH committed these
    shares; verification supplies that DAH).

    The orthogonal trees (columns ``positions`` of a row axis, rows of a
    column axis) are built on the EDS's device and leaf ``index`` of each
    is proven there (``proof.row_range_proofs``, which copies only those
    trees' cells).  A row axis passes the transposed view of the EDS: the
    Q0 prefix rule is symmetric, so row ``pos`` of the transpose has column
    ``pos``'s leaves."""
    eds = _eds_tensor(eds_shares, device)
    n = eds.shape[0]
    k = n // 2
    if positions is None:
        positions = tuple(range(k))
    orth = ExtendedDataSquare(eds.transpose(0, 1) if axis == AXIS_ROW else eds)
    span = [(index, index + 1)] * len(positions)
    proofs, shares, _ = row_range_proofs(orth, positions, span, share_ranges=span)
    return BadEncodingProof(
        axis=axis,
        index=index,
        square_size=k,
        positions=tuple(positions),
        shares=tuple(s[0] for s in shares),
        proofs=tuple(proofs),
    )
