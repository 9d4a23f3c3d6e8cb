"""Data-availability sampling (DAS): the light-client protocol the EDS
exists for.

Role: sampling-based availability verification — the reference ecosystem's
light nodes sample random EDS cells with NMT proofs so *no single node
needs the full square* (SURVEY.md §5 "long-context analogue"; the
2x-extension guarantees any withheld original data forces >= 75% of cells
to be withheld, spec `specs/src/specs/data_structures.md`).  celestia-app
itself serves the data; the DAS client lives beside it the way
celestia-node's light client does — here both halves are native to this
framework:

  SampleProof   — one EDS cell + its row-NMT range proof + the row root's
                  membership proof in the data root.
  sample_proof  — prover (node side), serving any cell of the 2k x 2k EDS
                  (all four quadrants, with the Q0/parity namespace rule).
  LightClient   — verifier: samples coordinates uniformly with a local
                  seed, verifies every proof against the header's data
                  root, and reports the soundness bound
                  P[withheld block undetected] <= (3/4)^n.

Host hashing: the host prover below hashes rows host-side (hashlib) and
serves only an EDS that lies on the CPU; an EDS on the card is always
proven on the card (da/device_plane.py).

Serving plane (the vectorized path a production node fields millions of
light clients through):

  sample_proofs_batch — one request -> n cells.  A block whose
      device-plane entry is cached on the EDS's device (da/device_plane.py:
      every block extended there, until evicted) is served by one K7b
      gather.  A miss for an EDS on the card -- not a fault path -- is
      served there too (device_plane.sample_proofs_from_eds: the touched
      rows' level stacks by K2's row-set mode + K3, the root tree by one
      K4, one K7b gather).  A miss for an EDS on the CPU goes to the host
      prover: coordinates are grouped by row, each touched row's NMT level
      stack is built ONCE through the host batch hasher
      (ops/sha256.sha256_batch_host), and one RFC-6962 level tree over
      the DAH's 4k axis roots serves every cell's root proof.  Emitted
      proofs are byte-identical to the per-cell prover.
  das_rows cache — bounded LruCache (celint R2) of immutable row level
      stacks keyed ``(data_root, row)`` (plus the block's root tree at
      ``(data_root, "roots")``), layered on top of the EDS cache: a warm
      block answers ANY cell of a cached row with pure proof-path
      extraction.  Keys bind to the data root, so a stack cached for one
      block can never serve another; hit/miss telemetry rides the
      unified cache registry like every other cache.

Re-homed from ``celestia_tpu/da/das.py``: the imports, the env names
(``CELESTIA_TPU_TORCH_DAS_ROWS(_MB)``), host reads of single rows in place
of the whole EDS, and the device routing of :func:`sample_proofs_batch`
(misses on the card served on the card; no ``except`` that falls back: a
failing gather raises) differ.  :func:`host_prover_calls` counts the
batches the host prover served.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from celestia_tpu_torch.appconsts import NAMESPACE_SIZE, SHARE_SIZE
from celestia_tpu_torch.da.dah import DataAvailabilityHeader, ExtendedDataSquare
from celestia_tpu_torch.da.namespace import PARITY_SHARE_NAMESPACE
from celestia_tpu_torch.da.proof import (
    MerkleProof,
    NmtRangeProof,
    merkle_level_tree,
    merkle_proof,
    merkle_proof_from_levels,
    nmt_range_proof_from_levels,
)
from celestia_tpu_torch.ops import nmt as nmt_ops
from celestia_tpu_torch.utils.lru import LruCache

_prover_lock = threading.Lock()
_host_prover_calls = 0  # guarded by _prover_lock


def host_prover_calls() -> int:
    """Batches the host prover served in this process (cache misses)."""
    with _prover_lock:
        return _host_prover_calls


def reset_host_prover_calls() -> None:
    global _host_prover_calls
    with _prover_lock:
        _host_prover_calls = 0


def _count_host_prover() -> None:
    global _host_prover_calls
    with _prover_lock:
        _host_prover_calls += 1


def _row_leaves(eds: ExtendedDataSquare, row: int) -> np.ndarray:
    """Namespace-prefixed NMT leaves of one EDS row (Q0 keeps own
    namespaces; every parity cell gets the parity namespace —
    pkg/wrapper's Push rule)."""
    return _leaves_of_row(eds.row(row), row, eds.square_size)


def _leaves_of_row(cells: np.ndarray, row: int, k: int) -> np.ndarray:
    """:func:`_row_leaves` of row ``row``'s cells uint8[2k, 512] on the host."""
    n = 2 * k
    prefix = np.empty((n, NAMESPACE_SIZE), dtype=np.uint8)
    parity_ns = np.frombuffer(PARITY_SHARE_NAMESPACE.raw, dtype=np.uint8)
    if row < k:
        prefix[:k] = cells[:k, :NAMESPACE_SIZE]
        prefix[k:] = parity_ns
    else:
        prefix[:] = parity_ns
    return np.concatenate([prefix, cells], axis=1)


def _host_level_stack(leaves: np.ndarray) -> List[np.ndarray]:
    """NMT level stack of one small tree on the host (serial reference;
    the serving path uses :func:`_row_level_stacks_host`, pinned
    byte-identical to this by tests/test_das.py)."""
    digests = [
        nmt_ops.leaf_digest_np(leaves[i].tobytes()) for i in range(len(leaves))
    ]
    levels = [np.frombuffer(b"".join(digests), dtype=np.uint8).reshape(-1, 90)]
    while len(digests) > 1:
        digests = [
            nmt_ops.combine_digests_np(digests[2 * i], digests[2 * i + 1])
            for i in range(len(digests) // 2)
        ]
        levels.append(
            np.frombuffer(b"".join(digests), dtype=np.uint8).reshape(-1, 90)
        )
    return levels


_PARITY_NS = np.frombuffer(PARITY_SHARE_NAMESPACE.raw, dtype=np.uint8)


def _row_level_stacks_host(leaves: np.ndarray) -> List[List[np.ndarray]]:
    """Level stacks of R same-size NMTs: uint8[R, n, L] namespace-prefixed
    leaves -> R stacks of ``[(n, 90), (n/2, 90), ..., (1, 90)]``.

    The batched counterpart of :func:`_host_level_stack`: ONE
    ``sha256_batch_host`` dispatch per tree level across ALL rows
    instead of
    rows x leaves scalar hashlib calls.  Byte-identical by construction
    — same leaf rule (ns || ns || sha256(0x00 || leaf)) and the same
    IgnoreMaxNamespace combine as ops/nmt.combine_digests_np.  Returned
    arrays are frozen (read-only): they are shared through the das_rows
    cache."""
    from celestia_tpu_torch.ops.sha256 import sha256_batch_host

    R, n, L = leaves.shape
    ns = leaves[:, :, :NAMESPACE_SIZE]
    prefix = np.zeros((R, n, 1), dtype=np.uint8)
    h = sha256_batch_host(
        np.concatenate([prefix, leaves], axis=-1).reshape(R * n, L + 1)
    ).reshape(R, n, 32)
    levels = [np.concatenate([ns, ns, h], axis=-1)]
    while levels[-1].shape[1] > 1:
        cur = levels[-1]
        left, right = cur[:, 0::2], cur[:, 1::2]
        l_max = left[..., NAMESPACE_SIZE : 2 * NAMESPACE_SIZE]
        r_min = right[..., :NAMESPACE_SIZE]
        r_max = right[..., NAMESPACE_SIZE : 2 * NAMESPACE_SIZE]
        r_is_parity = np.all(r_min == _PARITY_NS, axis=-1, keepdims=True)
        max_ns = np.where(r_is_parity, l_max, r_max)
        one = np.ones(left.shape[:-1] + (1,), dtype=np.uint8)
        h = sha256_batch_host(
            np.concatenate([one, left, right], axis=-1).reshape(
                -1, 1 + 2 * nmt_ops.NMT_DIGEST_SIZE
            )
        ).reshape(left.shape[:-1] + (32,))
        levels.append(
            np.concatenate([left[..., :NAMESPACE_SIZE], max_ns, h], axis=-1)
        )
    stacks: List[List[np.ndarray]] = []
    for r in range(R):
        stack = []
        for lv in levels:
            a = np.ascontiguousarray(lv[r])
            a.flags.writeable = False
            stack.append(a)
        stacks.append(stack)
    return stacks


# ---------------------------------------------------------------------------
# das_rows: the bounded proof/row cache (serving plane, ROADMAP #4)
# ---------------------------------------------------------------------------

# Keys: (data_root, row) -> that row's frozen NMT level stack;
#        (data_root, "roots") -> the block's RFC-6962 level tree over the
#        4k axis roots.  Binding every key to the data root means a warm
#        entry can NEVER serve a different block — a wrong root is a
#        plain miss, recomputed honestly (adversarial tests pin this).
# A k=128 row stack is ~46 KiB (2 x 256 x 90 B of digests), so the
# default byte budget (~32 MiB) holds several hundred hot rows across a
# handful of recent blocks on top of the EDS cache's squares.
_ROWS_MAX_ENTRIES = int(os.environ.get("CELESTIA_TPU_TORCH_DAS_ROWS", "8192"))
_ROWS_MAX_BYTES = int(
    float(os.environ.get("CELESTIA_TPU_TORCH_DAS_ROWS_MB", "32")) * 1024 * 1024
)


def _levels_weigher(key, value) -> int:
    try:
        return sum(int(lv.nbytes) for lv in value) + 64
    except Exception:
        return 64


_ROWS_CACHE = LruCache(
    "das_rows",
    _ROWS_MAX_ENTRIES,
    weigher=_levels_weigher,
    max_bytes=_ROWS_MAX_BYTES,
)


def rows_cache() -> LruCache:
    """The process-global das_rows cache (content keyed: sharing across
    App instances is safe for the same reason the EDS cache is)."""
    return _ROWS_CACHE


@dataclass(frozen=True)
class SampleProof:
    """One sampled EDS cell, provable to the block's data root."""

    row: int
    col: int
    square_size: int  # original k
    share: bytes  # 512-byte cell
    nmt_proof: NmtRangeProof  # within the row's NMT
    row_root: bytes
    root_proof: MerkleProof  # row root -> data root

    def leaf(self) -> bytes:
        """The ns-prefixed NMT leaf this cell hashes to."""
        k = self.square_size
        if self.row < k and self.col < k:
            prefix = self.share[:NAMESPACE_SIZE]
        else:
            prefix = PARITY_SHARE_NAMESPACE.raw
        return prefix + self.share

    def verify(self, data_root: bytes) -> bool:
        k = self.square_size
        if not (0 <= self.row < 2 * k and 0 <= self.col < 2 * k):
            return False
        if len(self.share) != SHARE_SIZE:
            return False
        if self.nmt_proof.start != self.col or self.nmt_proof.end != self.col + 1:
            return False
        if not self.nmt_proof.verify(self.row_root, [self.leaf()], 2 * k):
            return False
        # the row root's position among the DAH's 4k roots is its row index
        if self.root_proof.index != self.row or self.root_proof.total != 4 * k:
            return False
        return self.root_proof.verify(data_root, self.row_root)

    def to_dict(self) -> dict:
        return {
            "row": self.row,
            "col": self.col,
            "square_size": self.square_size,
            "share": self.share.hex(),
            "nmt": {
                "start": self.nmt_proof.start,
                "end": self.nmt_proof.end,
                "nodes": [n.hex() for n in self.nmt_proof.nodes],
            },
            "row_root": self.row_root.hex(),
            "root": {
                "index": self.root_proof.index,
                "total": self.root_proof.total,
                "aunts": [a.hex() for a in self.root_proof.aunts],
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SampleProof":
        return cls(
            row=int(d["row"]),
            col=int(d["col"]),
            square_size=int(d["square_size"]),
            share=bytes.fromhex(d["share"]),
            nmt_proof=NmtRangeProof(
                int(d["nmt"]["start"]),
                int(d["nmt"]["end"]),
                tuple(bytes.fromhex(n) for n in d["nmt"]["nodes"]),
            ),
            row_root=bytes.fromhex(d["row_root"]),
            root_proof=MerkleProof(
                index=int(d["root"]["index"]),
                total=int(d["root"]["total"]),
                aunts=tuple(bytes.fromhex(a) for a in d["root"]["aunts"]),
            ),
        )


def _sample_proof_uncached(
    eds: ExtendedDataSquare,
    dah: DataAvailabilityHeader,
    row: int,
    col: int,
) -> SampleProof:
    """The original per-cell prover: rebuilds the row's full level stack
    and the 4k-root list on EVERY call, touching no cache.  Kept as the
    byte-identity reference for the batch path (tests + the bench leg's
    per-sample baseline); production callers use :func:`sample_proof` /
    :func:`sample_proofs_batch`."""
    k = eds.square_size
    if not (0 <= row < 2 * k and 0 <= col < 2 * k):
        raise ValueError(f"sample ({row}, {col}) outside the {2*k}x{2*k} EDS")
    cells = eds.row(row)
    levels = _host_level_stack(_leaves_of_row(cells, row, k))
    nmt_proof = nmt_range_proof_from_levels(levels, col, col + 1)
    all_roots = list(dah.row_roots) + list(dah.col_roots)
    return SampleProof(
        row=row,
        col=col,
        square_size=k,
        share=cells[col].tobytes(),
        nmt_proof=nmt_proof,
        row_root=dah.row_roots[row],
        root_proof=merkle_proof(all_roots, row),
    )


def sample_proof(
    eds: ExtendedDataSquare,
    dah: DataAvailabilityHeader,
    row: int,
    col: int,
) -> SampleProof:
    """Prove one EDS cell (any quadrant) to the data root.

    Internally a 1-cell :func:`sample_proofs_batch`: the single-cell RPC
    path shares the das_rows cache, so a warm row answers with pure
    proof-path extraction and the 4k-root merkle tree is built once per
    block instead of once per call."""
    return sample_proofs_batch(eds, dah, [(row, col)])[0]


def sample_proofs_batch(
    eds: ExtendedDataSquare,
    dah: DataAvailabilityHeader,
    coords: Sequence[Tuple[int, int]],
) -> List[SampleProof]:
    """Prove n EDS cells in one pass (proofs returned in ``coords``
    order, each byte-identical to the per-cell prover's output).

    On the card, see the module docstring.  On the CPU without an entry,
    coordinates are grouped by row; every touched row's level stack is
    built ONCE through the batched host kernels and cached under
    ``(data_root, row)``, and one cached RFC-6962 level tree over the
    DAH's 4k axis roots serves every root proof — n samples of a warm
    block cost n proof-path extractions, not n full row passes."""
    k = eds.square_size
    n2 = 2 * k
    coords = [(int(r), int(c)) for r, c in coords]
    for row, col in coords:
        if not (0 <= row < n2 and 0 <= col < n2):
            raise ValueError(
                f"sample ({row}, {col}) outside the {n2}x{n2} EDS"
            )
    if not coords:
        return []
    data_root = dah.hash
    # device-resident serving (da/device_plane.py): if this block's level
    # stacks are still on the EDS's device (any block extended there, until
    # evicted), a proof is an index computation plus ONE K7b gather and
    # ONE fetch of the proof paths — no row rebuild, no re-hash.  A miss
    # on the card rebuilds the touched rows there (K2's row-set mode + K3,
    # the root tree one K4) and gathers the same way; only an EDS on the
    # CPU goes to the host prover below.  Byte-identical throughout; a
    # failing gather raises.
    from celestia_tpu_torch.da import device_plane, eds_cache

    device = eds.tensor.device
    dev_entry = eds_cache.get_device_entry(data_root, device)
    if dev_entry is not None and dev_entry.k == k:
        return device_plane.sample_proofs_batch(dev_entry, dah, coords)
    if device.type != "cpu":
        return device_plane.sample_proofs_from_eds(eds.tensor, dah, coords)
    _count_host_prover()
    all_roots = list(dah.row_roots) + list(dah.col_roots)
    total = len(all_roots)
    # root-proof material: one balanced level tree per block (4k is a
    # power of two whenever k is; anything else falls back to the
    # per-call prover's tree walk)
    root_levels = None
    if total and not (total & (total - 1)):
        root_levels = _ROWS_CACHE.get((data_root, "roots"))
        if root_levels is None:
            root_levels = merkle_level_tree(all_roots)
            _ROWS_CACHE.put((data_root, "roots"), root_levels)
    rows_needed = sorted({r for r, _ in coords})
    # the touched rows (the EDS lies on the CPU here)
    cells = dict(zip(rows_needed, eds.rows(rows_needed)))
    cached = _ROWS_CACHE.get_many([(data_root, r) for r in rows_needed])
    stacks = {
        r: s for r, s in zip(rows_needed, cached) if s is not None
    }
    missing = [r for r in rows_needed if r not in stacks]
    if missing:
        built = _row_level_stacks_host(
            np.stack([_leaves_of_row(cells[r], r, k) for r in missing])
        )
        _ROWS_CACHE.put_many(
            ((data_root, r), s) for r, s in zip(missing, built)
        )
        stacks.update(zip(missing, built))
    out: List[SampleProof] = []
    for row, col in coords:
        nmt_proof = nmt_range_proof_from_levels(stacks[row], col, col + 1)
        root_proof = (
            merkle_proof_from_levels(root_levels, row)
            if root_levels is not None
            else merkle_proof(all_roots, row)
        )
        out.append(
            SampleProof(
                row=row,
                col=col,
                square_size=k,
                share=cells[row][col].tobytes(),
                nmt_proof=nmt_proof,
                row_root=dah.row_roots[row],
                root_proof=root_proof,
            )
        )
    return out


@dataclass
class SampleResult:
    coordinates: List[Tuple[int, int]]
    verified: int
    failed: List[Tuple[int, int, str]]  # (row, col, reason)

    @property
    def available(self) -> bool:
        return not self.failed

    @property
    def confidence(self) -> float:
        """P[an unavailable block would have escaped detection] is at most
        (3/4)^n: recovering a withheld share requires withholding > 25% of
        the EDS (k+1 of 2k cells in some axis), so each uniformly-sampled
        cell is withheld with probability > 1/4."""
        return 1.0 - 0.75 ** self.verified


class LightClient:
    """DAS verifier: trusts only a header (data root + square size)."""

    def __init__(self, data_root: bytes, square_size: int, seed: int = 0):
        self.data_root = data_root
        self.k = square_size
        # celint: allow(consensus-determinism) — explicitly seeded sampling
        # RNG: cell choice is a client-local probabilistic check whose
        # draws never reach consensus bytes, and the seed keeps it
        # reproducible in tests
        self._rng = np.random.default_rng(seed)

    def pick_coordinates(self, n: int) -> List[Tuple[int, int]]:
        n_axis = 2 * self.k
        flat = self._rng.choice(n_axis * n_axis, size=min(n, n_axis * n_axis),
                                replace=False)
        return [(int(f) // n_axis, int(f) % n_axis) for f in flat]

    def sample(
        self,
        fetch: Optional[Callable[[int, int], Optional[SampleProof]]] = None,
        n_samples: int = 16,
        *,
        fetch_batch: Optional[
            Callable[[List[Tuple[int, int]]], Iterable[Optional[SampleProof]]]
        ] = None,
    ) -> SampleResult:
        """Fetch + verify n uniformly-random cells.  A None response, a
        proof for the wrong coordinate, or a proof that fails verification
        all count as withheld — a provider must PROVE every sampled cell.

        ``fetch_batch`` routes the whole draw through the vectorized
        serving plane (ONE request for all n cells — the DasSampleBatch
        RPC); it receives the coordinate list and returns proofs (or
        None) positionally.  A short response leaves the tail cells
        "not served" — a provider cannot shrink the sample."""
        if (fetch is None) == (fetch_batch is None):
            raise ValueError("exactly one of fetch/fetch_batch is required")
        coords = self.pick_coordinates(n_samples)
        if fetch_batch is not None:
            proofs = list(fetch_batch(list(coords)))
            proofs += [None] * (len(coords) - len(proofs))
        else:
            proofs = [fetch(row, col) for row, col in coords]
        verified = 0
        failed: List[Tuple[int, int, str]] = []
        for (row, col), proof in zip(coords, proofs):
            if proof is None:
                failed.append((row, col, "not served"))
                continue
            if (proof.row, proof.col) != (row, col):
                failed.append((row, col, "proof for the wrong coordinate"))
                continue
            if proof.square_size != self.k:
                failed.append((row, col, "square size mismatch"))
                continue
            if not proof.verify(self.data_root):
                failed.append((row, col, "proof does not verify"))
                continue
            verified += 1
        return SampleResult(coords, verified, failed)
