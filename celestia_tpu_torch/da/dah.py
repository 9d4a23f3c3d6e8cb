"""Extended data square + DataAvailabilityHeader: the block-extension hot path.

Counterpart of ``celestia_tpu/da/dah.py`` with behavioral parity with
pkg/da/data_availability_header.go (ExtendShares :65-75,
NewDataAvailabilityHeader :44-63, Hash :92-108, ValidateBasic :134-177,
MinDataAvailabilityHeader :179) and app/extend_block.go:14-32.

The block entry points (:func:`extend_and_header`, :func:`extend_block`,
:func:`new_data_availability_header`, :func:`min_data_availability_header`)
pick their regime from the device they resolve to.

* On the card (``device=None`` or ``"cuda:N"``; ``None`` raises without a
  card) :func:`extend_and_header` goes through the device-resident plane
  (da/device_plane.py), as the JAX package does with an accelerator
  attached (its dah.py:540): the square is uploaded once, RS extension
  (K5) -> NMT leaf digests (K2) -> every NMT level in one launch (K3) ->
  the root tree from the axis roots in one launch (K4) run on the current
  stream with no host sync between them, only the 4k axis roots and the
  32-byte data root come back to the host, and the EDS and every level
  stay on the card, cached under the data root for DAS serving.
* On the CPU (``device="cpu"``) they run the JAX package's host regime
  (its dah.py:197-677): the native library's fused extension and root
  pass (``extend_block_leopard_cpu`` or ``extend_block_cpu`` by codec),
  the row memo under ``lagrange-gf256``, and the native root pass for an
  existing EDS.  Nothing is launched and no devprof dispatch is recorded.
  Without the library, or when a native leg fails, the call raises: there
  is no plain fallback and nothing is poisoned.  The plane on the CPU (the
  plain PyTorch twins) is reached only by calling
  ``device_plane.extend_and_header(square, device="cpu")`` directly.

An EDS on the card is fetched whole only when :attr:`ExtendedDataSquare.shares`
is read; :meth:`ExtendedDataSquare.rows` copies only the rows asked for.
:func:`full_eds_fetches` counts the whole-square fetches, so a run can show
that a serving path never made one.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from celestia_tpu_torch.appconsts import (
    DEFAULT_SQUARE_SIZE_UPPER_BOUND,
    SHARE_SIZE,
    is_power_of_two,
)
from celestia_tpu_torch.da.square import Square
from celestia_tpu_torch.ops import gf256
from celestia_tpu_torch.ops import nmt as nmt_ops
from celestia_tpu_torch.ops import rs
from celestia_tpu_torch.utils import tracing
from celestia_tpu_torch.utils.device import resolve_device
from celestia_tpu_torch.utils.lru import LruCache
from celestia_tpu_torch.utils.telemetry import clock

NMT_ROOT_SIZE = nmt_ops.NMT_DIGEST_SIZE  # 90

_fetch_lock = threading.Lock()
_full_fetches = 0  # guarded by _fetch_lock


def full_eds_fetches() -> int:
    """Whole EDSs copied from a device to the host in this process."""
    with _fetch_lock:
        return _full_fetches


def reset_full_eds_fetches() -> None:
    global _full_fetches
    with _fetch_lock:
        _full_fetches = 0


def _writable(arr) -> np.ndarray:
    """A contiguous uint8 array torch may wrap: read-only arrays (a Square's
    frozen view) are copied, since torch tensors have no read-only flag."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    return arr if arr.flags.writeable else arr.copy()


class ExtendedDataSquare:
    """A 2k x 2k erasure-extended share square (rsmt2d.ExtendedDataSquare parity).

    Holds the share tensor uint8[2k, 2k, 512] (on the card or the CPU); Q0
    (top-left k x k) is the original data square.  Accepts a numpy array
    (for instance the JAX package's EDS) or a torch tensor; a tensor on the
    card stays there until :attr:`shares` is read.
    """

    def __init__(self, shares):
        if isinstance(shares, torch.Tensor):
            if shares.dtype != torch.uint8:
                raise ValueError(f"EDS shares must be uint8, got {shares.dtype}")
            tensor = shares
        else:
            tensor = torch.from_numpy(_writable(shares))
        n = tensor.shape[0]
        if (
            tensor.dim() != 3
            or tuple(tensor.shape) != (n, n, SHARE_SIZE)
            or n % 2
            or not is_power_of_two(n // 2)
        ):
            raise ValueError(f"invalid EDS shape {tuple(tensor.shape)}")
        self._tensor = tensor
        self._shares = tensor.numpy() if tensor.device.type == "cpu" else None

    @property
    def tensor(self) -> torch.Tensor:
        """The share tensor where it lies (no transfer)."""
        return self._tensor

    @property
    def shares(self) -> np.ndarray:
        """All shares on the host (a whole-square copy from a device, once)."""
        global _full_fetches
        if self._shares is None:
            self._shares = self._tensor.cpu().numpy()
            with _fetch_lock:
                _full_fetches += 1
        return self._shares

    def rows(self, idxs) -> np.ndarray:
        """Rows ``idxs`` on the host, uint8[len(idxs), 2k, 512]: from a
        device only those rows are copied, in one transfer."""
        idxs = [int(r) for r in idxs]
        if self._shares is not None:
            return self._shares[idxs]
        index = torch.tensor(idxs, dtype=torch.long, device=self._tensor.device)
        return self._tensor.index_select(0, index).cpu().numpy()

    @property
    def width(self) -> int:
        # shape is metadata — never forces a device->host transfer
        return self._tensor.shape[0]

    @property
    def square_size(self) -> int:
        """Original (unextended) square width k."""
        return self.width // 2

    def row(self, r: int) -> np.ndarray:
        return self.rows([r])[0]

    def col(self, c: int) -> np.ndarray:
        return self.shares[:, c]

    def quadrant(self, q: int) -> np.ndarray:
        k = self.square_size
        r, c = divmod(q, 2)
        return self.shares[r * k : (r + 1) * k, c * k : (c + 1) * k]

    def flattened_original(self) -> np.ndarray:
        """Q0 as uint8[k*k, 512] (row-major original shares)."""
        k = self.square_size
        return self.quadrant(0).reshape(k * k, SHARE_SIZE)


@dataclass(frozen=True)
class DataAvailabilityHeader:
    """Row/column NMT roots + memoized hash (= the block's data root)."""

    row_roots: Tuple[bytes, ...]
    col_roots: Tuple[bytes, ...]
    _hash: bytes

    @property
    def hash(self) -> bytes:
        return self._hash

    @property
    def square_size(self) -> int:
        return len(self.row_roots) // 2

    def validate_basic(self) -> None:
        """dah ValidateBasic parity: extended square bounds + root shapes +
        hash consistency (data_availability_header.go:134-177)."""
        n = len(self.row_roots)
        if n == 0 or n != len(self.col_roots):
            raise ValueError("row/col root counts must match and be non-empty")
        k = n // 2
        if n % 2 or not is_power_of_two(k):
            raise ValueError(f"extended square width {n} must be 2 * power-of-two")
        if k > DEFAULT_SQUARE_SIZE_UPPER_BOUND:
            raise ValueError(
                f"square size {k} exceeds upper bound {DEFAULT_SQUARE_SIZE_UPPER_BOUND}"
            )
        for r in (*self.row_roots, *self.col_roots):
            if len(r) != NMT_ROOT_SIZE:
                raise ValueError(f"NMT root must be {NMT_ROOT_SIZE} bytes")
        if self.compute_hash(self.row_roots, self.col_roots) != self._hash:
            raise ValueError("DAH hash does not match its roots")

    @staticmethod
    def compute_hash(row_roots, col_roots) -> bytes:
        return nmt_ops.rfc6962_root_np(list(row_roots) + list(col_roots)).tobytes()

    def to_bytes(self) -> bytes:
        """Deterministic wire form: counts + concatenated roots."""
        out = bytearray()
        out += len(self.row_roots).to_bytes(4, "big")
        for r in self.row_roots:
            out += r
        out += len(self.col_roots).to_bytes(4, "big")
        for c in self.col_roots:
            out += c
        return bytes(out)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "DataAvailabilityHeader":
        n_rows = int.from_bytes(raw[:4], "big")
        pos = 4
        rows = []
        for _ in range(n_rows):
            rows.append(raw[pos : pos + NMT_ROOT_SIZE])
            pos += NMT_ROOT_SIZE
        n_cols = int.from_bytes(raw[pos : pos + 4], "big")
        pos += 4
        cols = []
        for _ in range(n_cols):
            cols.append(raw[pos : pos + NMT_ROOT_SIZE])
            pos += NMT_ROOT_SIZE
        if pos != len(raw):
            raise ValueError("trailing bytes in DAH encoding")
        dah = cls(tuple(rows), tuple(cols), cls.compute_hash(rows, cols))
        dah.validate_basic()
        return dah


def _check_square(arr: np.ndarray) -> int:
    k = arr.shape[0]
    if arr.shape != (k, k, SHARE_SIZE) or not is_power_of_two(k):
        raise ValueError(
            f"square must be (k, k, {SHARE_SIZE}) with k a power of two, got {arr.shape}"
        )
    return k


def _square_tensor(square, device: torch.device) -> torch.Tensor:
    """One upload of a host square (numpy, uint8[k, k, 512]) to ``device``."""
    arr = _writable(square)
    _check_square(arr)
    return torch.from_numpy(arr).to(device)


def extend_shares(shares: np.ndarray, device=None) -> ExtendedDataSquare:
    """da.ExtendShares parity: uint8[n, 512] (n a perfect power-of-4 count)
    -> ExtendedDataSquare."""
    dev = resolve_device(device)
    shares = np.asarray(shares, dtype=np.uint8)
    n = shares.shape[0]
    k = int(round(n**0.5))
    if k * k != n or not is_power_of_two(k):
        raise ValueError(f"share count {n} must be a square of a power of two")
    square = _square_tensor(shares.reshape(k, k, SHARE_SIZE), dev)
    return ExtendedDataSquare(rs.extend_square(square))


# ---------------------------------------------------------------------------
# The host regime (JAX dah.py:197-677): the native library's legs.
# ---------------------------------------------------------------------------


def _dah_from_roots(roots: np.ndarray, data_root: np.ndarray) -> DataAvailabilityHeader:
    """The DAH from the native pass's uint8[4k, 90] roots (rows, then
    columns) and its data root."""
    n2 = roots.shape[0] // 2
    return DataAvailabilityHeader(
        tuple(roots[i].tobytes() for i in range(n2)),
        tuple(roots[n2 + i].tobytes() for i in range(n2)),
        data_root.tobytes(),
    )


def _native_extend(square: np.ndarray):
    """The fused native pipeline of the active codec: square ->
    (eds, roots uint8[4k, 90], data root)."""
    from celestia_tpu_torch.utils import native

    if gf256.active_codec() == gf256.CODEC_LEOPARD:
        return native.extend_block_leopard_cpu(square)
    return native.extend_block_cpu(square)


def _extend_and_header_host(
    square: np.ndarray,
) -> Tuple[ExtendedDataSquare, DataAvailabilityHeader]:
    """Host-regime ExtendBlock (JAX :207): the pooled native C++ pipeline
    with the extend->roots overlap, byte-identical to the plane."""
    from celestia_tpu_torch.utils import hostpool

    # the fused C++ call computes extension AND all 4k roots; the span
    # args (built only when the tracer is on: this is the per-block host
    # hot path) record the fusion, so the roots phase below is the DAH's
    # assembly, not the hashing
    span = (
        tracing.span(
            "extend.native",
            codec=gf256.active_codec(),
            fused_roots=True,
            nthreads=hostpool.cpu_threads(),
            phases=3,
        )
        if tracing.enabled()
        else tracing.NULL_SPAN
    )
    with span:
        eds, roots, data_root = _native_extend(square)
    with tracing.span("roots", stage="assemble", fused_native=True):
        dah = _dah_from_roots(roots, data_root)
    return ExtendedDataSquare(eds), dah


# Row-level extension memoization (JAX :249-281).  Consecutive heights
# share rows whose bytes have not changed (tail padding, namespace
# padding, unchanged blob rows), and within one square the padding rows
# are identical.  Row extension and the ROW tree are pure per-row
# functions, so digest(row bytes) determines both the parity row and the
# row root; column extension and column roots always recompute.  As in
# JAX, the memo engages only under lagrange-gf256 (the table method), where
# reuse beats the fused pipeline; under leopard-ff8 the FFT pipeline is
# faster than any selective assembly, and not even digests are computed.
# The card bypasses the memo: its redundant work is removed one level up
# by the content-addressed EDS cache (da/eds_cache.py).


class _RowMemo:
    """(k, codec, sha256(row bytes)) -> (parity row bytes, row root bytes),
    over utils/lru.py with JAX's stats keys."""

    def __init__(self, max_entries: int):
        self._lru = LruCache("row_memo", max_entries, weigher=_row_memo_weigher)
        self.assembled = 0  # squares served by the memoized assembly path

    @property
    def max_entries(self) -> int:
        return self._lru.max_entries

    def lookup_many(self, k: int, codec: str, digests: List[bytes]):
        return self._lru.get_many((k, codec, d) for d in digests)

    def insert_many(self, k: int, codec: str, items) -> None:
        """items: iterable of (digest, parity_bytes, root_bytes)."""
        self._lru.put_many(((k, codec, d), (parity, root)) for d, parity, root in items)

    def mark_assembled(self) -> None:
        self.assembled += 1

    def clear(self) -> None:
        self._lru.clear()
        self.assembled = 0

    def stats(self) -> dict:
        s = self._lru.stats()
        lookups = s["hits"] + s["misses"]
        return {
            "entries": s["entries"],
            "lookups": lookups,
            "hits": s["hits"],
            "inserted": s["puts"],
            "assembled": self.assembled,
            "reuse_pct": (100.0 * s["hits"] / lookups) if lookups else 0.0,
            "approx_bytes": s["approx_bytes"],
        }


def _row_memo_weigher(key, value) -> int:
    parity, root = value
    return len(parity) + len(root) + 64


# one entry holds a k x 512 B parity row (64 KiB at k = 128): 512 entries
# bound the memo around 32 MiB
_ROW_MEMO = _RowMemo(int(os.environ.get("CELESTIA_TPU_TORCH_ROW_MEMO", "512")))


def row_memo_stats() -> dict:
    return _ROW_MEMO.stats()


def clear_row_memo() -> None:
    _ROW_MEMO.clear()


def _row_digests(square: np.ndarray) -> List[bytes]:
    """sha256 per original row (the memo keys), threaded in the library."""
    from celestia_tpu_torch.utils import native

    k = square.shape[0]
    d = native.sha256_batch(np.ascontiguousarray(square.reshape(k, -1)))
    return [d[i].tobytes() for i in range(k)]


def _row_memo_applicable() -> bool:
    """True when the memoized assembly can beat the fused pipeline: the
    table-method codec (JAX :379, whose no-native leg the port lacks)."""
    return gf256.active_codec() == gf256.CODEC_LAGRANGE


def _gf_encode_axis(X: np.ndarray) -> np.ndarray:
    """E(k) @ X over GF(256) in the active codec: uint8[k, B'] -> uint8[k, B'].

    Row parity for missed rows and the column extension are the same
    encode matrix applied along axis 0.  The native table matmul threads
    across axes, so the byte dimension is chunked over the pool
    (zero-padding is exact: a GF matmul is column-independent)."""
    from celestia_tpu_torch.utils import hostpool, native

    k, Bp = X.shape
    E = np.ascontiguousarray(gf256.encode_matrix(k))
    T = max(1, min(hostpool.cpu_threads(), Bp // 4096))
    if T == 1:
        return native.gf_matmul_axes(E[None], np.ascontiguousarray(X)[None])[0]
    chunk = -(-Bp // T)
    pad = T * chunk - Bp
    if pad:
        X = np.concatenate([X, np.zeros((k, pad), dtype=np.uint8)], axis=1)
    Xc = np.ascontiguousarray(X.reshape(k, T, chunk).transpose(1, 0, 2))
    D = np.ascontiguousarray(np.broadcast_to(E, (T, k, k)))
    out = native.gf_matmul_axes(D, Xc)  # (T, k, chunk)
    out = out.transpose(1, 0, 2).reshape(k, T * chunk)
    return np.ascontiguousarray(out[:, :Bp])


def _try_memoized_extend(
    square: np.ndarray, digests: List[bytes]
) -> Optional[Tuple[ExtendedDataSquare, DataAvailabilityHeader]]:
    """Assemble (EDS, DAH) from the row memo (JAX :418), or None when fewer
    than a quarter of the k row extensions are saved, by memo hits from
    earlier heights or by duplicate rows within the square.  The roots
    come from the native full pass over all 4k trees (JAX :457-466)."""
    from celestia_tpu_torch.utils import native

    k, B = square.shape[0], square.shape[2]
    codec = gf256.active_codec()
    entries = _ROW_MEMO.lookup_many(k, codec, digests)
    missing: Dict[bytes, int] = {}  # digest -> representative row
    for r, (d, e) in enumerate(zip(digests, entries)):
        if e is None and d not in missing:
            missing[d] = r
    if k - len(missing) < max(1, k // 4):
        return None
    n2 = 2 * k
    with tracing.span(
        "extend.memo", k=k, memo_hits=k - len(missing), memo_misses=len(missing)
    ):
        top = np.empty((k, n2, B), dtype=np.uint8)
        top[:, :k] = square
        parity_by_digest: Dict[bytes, np.ndarray] = {}
        if missing:
            reps = list(missing.values())
            data = square[reps]  # (m, k, B)
            P = _gf_encode_axis(data.transpose(1, 0, 2).reshape(k, -1))
            par = P.reshape(k, len(reps), B).transpose(1, 0, 2)  # (m, k, B)
            for i, d in enumerate(missing):
                parity_by_digest[d] = par[i]
        for r, (d, e) in enumerate(zip(digests, entries)):
            if e is not None:
                top[r, k:] = np.frombuffer(e[0], dtype=np.uint8).reshape(k, B)
            else:
                top[r, k:] = parity_by_digest[d]
        bottom = _gf_encode_axis(top.reshape(k, -1)).reshape(k, n2, B)
        eds = np.concatenate([top, bottom], axis=0)
    # the threaded C++ pass over all 4k trees beats a selective reduction
    # even with most row roots memoized (JAX :457-463)
    with tracing.span("roots", stage="native_full_pass", trees=4 * k):
        all_roots = native.eds_nmt_roots(eds)
    row_roots = [all_roots[i].tobytes() for i in range(n2)]
    col_roots = [all_roots[n2 + i].tobytes() for i in range(n2)]
    root_by_digest = {d: row_roots[r] for d, r in missing.items()}
    dah = DataAvailabilityHeader(
        tuple(row_roots),
        tuple(col_roots),
        DataAvailabilityHeader.compute_hash(row_roots, col_roots),
    )
    _ROW_MEMO.insert_many(
        k, codec, ((d, top[r, k:].tobytes(), root_by_digest[d]) for d, r in missing.items())
    )
    _ROW_MEMO.mark_assembled()
    return ExtendedDataSquare(eds), dah


def _memo_populate(k: int, digests: List[bytes], eds_shares: np.ndarray, row_roots) -> None:
    """Record every distinct original row of a freshly extended square."""
    seen = set()
    items = []
    for r, d in enumerate(digests):
        if d in seen:
            continue
        seen.add(d)
        items.append((d, eds_shares[r, k:].tobytes(), row_roots[r]))
    _ROW_MEMO.insert_many(k, gf256.active_codec(), items)


def _extend_and_header_cpu(square) -> Tuple[ExtendedDataSquare, DataAvailabilityHeader]:
    """The host regime's extend (JAX :553-575): the row memo where it
    applies, else the fused native leg, whose rows then populate the memo.
    A native fault raises; the library is not poisoned."""
    from celestia_tpu_torch.utils import native

    native.require()
    square = np.ascontiguousarray(square, dtype=np.uint8)
    k = _check_square(square)
    digests: Optional[List[bytes]] = None
    if _row_memo_applicable():
        with tracing.span("row_digests", k=k):
            digests = _row_digests(square)
        memoized = _try_memoized_extend(square, digests)
        if memoized is not None:
            return memoized
    eds, dah = _extend_and_header_host(square)
    if digests is not None:
        _memo_populate(k, digests, eds.shares, dah.row_roots)
    return eds, dah


def extend_and_header(
    square: np.ndarray, device=None
) -> Tuple[ExtendedDataSquare, DataAvailabilityHeader]:
    """The fused hot path: original square uint8[k,k,512] -> (EDS, DAH).

    ``device=None`` runs on the card, through the device-resident plane
    (the block stays cached there for DAS serving), and raises when there
    is no card; ``device="cpu"`` runs the host regime (module docstring).
    The devprof brackets are the plane's (``extend_levels``); JAX's
    ``extend_and_roots`` bracket (:585) sits on its non-plane device leg,
    which the port does not have."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return _extend_and_header_cpu(square)
    from celestia_tpu_torch.da import device_plane

    return device_plane.extend_and_header(square, device=dev)


def extend_and_header_breakdown(square: np.ndarray, device=None):
    """:func:`extend_and_header` with its time split out (JAX :609):
    returns (eds, dah, {"upload_ms", "compute_ms", "fetch_ms"}).

    On the card: three syncs, the square's upload, the plane's launches
    (:func:`device_plane._extend_levels`; no entry is parked) and the
    fetch of the 4k axis roots and the data root, so the total is a few
    syncs WORSE than :func:`extend_and_header`.  On the CPU, the host
    leg's split: ``upload_ms`` the square made contiguous (nothing
    crosses), ``compute_ms`` the fused native call (extension, roots and
    data root), ``fetch_ms`` the DAH's assembly from its roots; no memo.
    Use it to attribute time, never on the hot path."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        from celestia_tpu_torch.utils import native

        native.require()
        t0 = clock()
        arr = np.ascontiguousarray(square, dtype=np.uint8)
        _check_square(arr)
        t1 = clock()
        eds, roots, data_root = _native_extend(arr)
        t2 = clock()
        dah = _dah_from_roots(roots, data_root)
        t3 = clock()
        eds = ExtendedDataSquare(eds)
    else:
        from celestia_tpu_torch.da import device_plane

        t0 = clock()
        sq = _square_tensor(square, dev)
        torch.cuda.synchronize(dev)
        t1 = clock()
        eds_t, _grid, levels, root_tree = device_plane._extend_levels(sq)
        torch.cuda.synchronize(dev)
        t2 = clock()
        host = torch.cat([levels[-1].reshape(-1), root_tree[-1]]).cpu().numpy()
        t3 = clock()
        split = host.size - 32
        dah = _dah_from_roots(host[:split].reshape(-1, NMT_ROOT_SIZE), host[split:])
        eds = ExtendedDataSquare(eds_t)
    return eds, dah, {
        "upload_ms": (t1 - t0) * 1000.0,
        "compute_ms": (t2 - t1) * 1000.0,
        "fetch_ms": (t3 - t2) * 1000.0,
    }


def new_data_availability_header(
    eds: ExtendedDataSquare, device=None
) -> DataAvailabilityHeader:
    """da.NewDataAvailabilityHeader parity: roots + hash from an existing
    EDS.  On the card the bracketed K2 + K3 pass; on the CPU the native
    library's threaded pass over the 4k trees (JAX :656-672)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        with tracing.span("roots", stage="host_pool", trees=2 * eds.width):
            roots = nmt_ops.eds_nmt_roots_host(eds.shares)
    else:
        roots = nmt_ops.eds_nmt_roots_device(eds.tensor.to(dev).contiguous()).cpu().numpy()
    rows = tuple(roots[0, i].tobytes() for i in range(roots.shape[1]))
    cols = tuple(roots[1, i].tobytes() for i in range(roots.shape[1]))
    return DataAvailabilityHeader(
        rows, cols, DataAvailabilityHeader.compute_hash(rows, cols)
    )


def extend_block(
    square: Square, device=None
) -> Tuple[ExtendedDataSquare, DataAvailabilityHeader]:
    """app.ExtendBlock parity (extend_block.go:14-26): square -> (EDS, DAH)."""
    k = square.size
    arr = square.to_array().reshape(k, k, SHARE_SIZE)
    return extend_and_header(arr, device=device)


def data_roots_batched(squares, device=None) -> Tuple[np.ndarray, Tuple[bytes, ...]]:
    """Catch-up validation of a batch of same-size blocks (the JAX
    package's ``node/network.py:396-417``): squares uint8[n, k, k, 512] ->
    (axis roots uint8[n, 2, 2k, 90], the n data roots).

    On the card: one K5b launch pair extends the batch, one K2 launch and
    one K3 launch hash all n * 4k trees to their roots, then one K4 launch
    gives every block's data root there (the JAX caller hashes the roots on the host);
    roots and data roots come back in one copy.  A numpy batch is uploaded
    to ``device`` (None: the card); a tensor stays on its device."""
    if isinstance(squares, torch.Tensor):
        batch = squares
    else:
        batch = torch.from_numpy(_writable(squares)).to(resolve_device(device))
    eds = rs.extend_squares_batched(batch)
    roots = nmt_ops.eds_nmt_roots(eds)  # (n, 2, 2k, 90)
    n, _, n2, _ = roots.shape
    data = nmt_ops.rfc6962_root_pow2(roots.reshape(n, 2 * n2, NMT_ROOT_SIZE))  # (n, 32)
    # celint: allow(host-sync) — the catch-up's one copy of every root and data root, which the caller compares on the host; JAX's caller fetches the same batch unbracketed (node/network.py), and the devprof ledger stays equal to JAX's
    host = torch.cat([roots.reshape(-1), data.reshape(-1)]).cpu().numpy()
    split = roots.numel()
    return (
        host[:split].reshape(tuple(roots.shape)),
        tuple(host[split:].reshape(n, 32)[i].tobytes() for i in range(n)),
    )


# codec -> min DAH; the lock serializes the first computation per codec so
# concurrent callers neither race it nor the insert
_min_dah_lock = threading.Lock()
_min_dah: Dict[str, DataAvailabilityHeader] = {}


def min_data_availability_header(device=None) -> DataAvailabilityHeader:
    """DAH of the minimal (empty) square: one tail-padding share
    (data_availability_header.go:179), cached per codec."""
    dev = resolve_device(device)
    codec = gf256.active_codec()
    with _min_dah_lock:
        hit = _min_dah.get(codec)
        if hit is None:
            from celestia_tpu_torch.da.square import build

            square, _, _ = build([])
            _, hit = extend_block(square, device=dev)
            _min_dah[codec] = hit
        return hit
