"""Versioned key-value multistore with an incrementally-maintained Merkle
app hash, copy-on-write branches, and pluggable disk persistence.

Role parity with the reference's IAVL/LevelDB commit-multistore (SURVEY.md
§2.1 "framework": baseapp stores, mounted at app/app.go:242): namespaced
substores per module, branch/cache-wrap semantics for speculative execution
(CheckTx / proposal processing / per-tx delivery), commit-per-height
versioning with app-hash, load-at-height rollback, height-pinned reads with
membership proofs, and full export/import for genesis and state-sync-style
snapshots.

Unlike the round-2 design (flatten + rehash all state per commit, full
deep-copy per height), commits now cost O(writes * log N):

- each substore keeps a compact sparse Merkle tree (state.merkle) over
  (sha256(key) -> sha256(value)); only keys written since the last commit
  are re-folded;
- the app hash is the hash of the sorted (store name, store root) pairs;
- history is kept as per-height REVERSE diffs (the values each block
  overwrote), bounded by ``history_keep``, so memory stays flat over long
  chains while recent heights remain queryable, provable and rollbackable;
- a persister callback receives every commit's forward diff for the
  append-only disk log (state.disk), which is what crash recovery replays.

Branches are overlay stores (write layer + read-through to the parent), so
branching is O(1) and a branch costs O(its own writes) — the cache-wrap
semantics of the SDK's CacheMultiStore.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, Iterator, List, Optional, Set, Tuple

from celestia_tpu_torch.state import merkle
from celestia_tpu_torch.state.merkle import EMPTY_ROOT


class _DictLayer:
    """Base storage layer backed by a plain dict, tracking per-commit
    write provenance: ``prev`` holds each key's value before its first
    write since the last commit (None = was absent) and ``unsynced``
    holds keys whose merkle leaves are stale."""

    def __init__(self, data: Optional[Dict[bytes, bytes]] = None):
        self.data: Dict[bytes, bytes] = data if data is not None else {}
        self.prev: Dict[bytes, Optional[bytes]] = {}
        self.unsynced: Set[bytes] = set()

    def get(self, key: bytes) -> Optional[bytes]:
        return self.data.get(key)

    def has(self, key: bytes) -> bool:
        return key in self.data

    def set(self, key: bytes, value: bytes) -> None:
        if key not in self.prev:
            self.prev[key] = self.data.get(key)
        self.unsynced.add(key)
        self.data[key] = value

    def delete(self, key: bytes) -> None:
        if key in self.data:
            if key not in self.prev:
                self.prev[key] = self.data[key]
            self.unsynced.add(key)
            del self.data[key]

    def keys(self) -> Set[bytes]:
        return set(self.data)


class _OverlayLayer:
    """Copy-on-write layer: local writes/deletes over a parent layer."""

    def __init__(self, parent):
        self.parent = parent
        self.writes: Dict[bytes, bytes] = {}
        self.deletes: Set[bytes] = set()

    def get(self, key: bytes) -> Optional[bytes]:
        if key in self.writes:
            return self.writes[key]
        if key in self.deletes:
            return None
        return self.parent.get(key)

    def has(self, key: bytes) -> bool:
        return self.get(key) is not None

    def set(self, key: bytes, value: bytes) -> None:
        self.writes[key] = value
        self.deletes.discard(key)

    def delete(self, key: bytes) -> None:
        self.writes.pop(key, None)
        self.deletes.add(key)

    def keys(self) -> Set[bytes]:
        return (self.parent.keys() - self.deletes) | set(self.writes)

    def apply_to_parent(self) -> None:
        for k, v in self.writes.items():
            self.parent.set(k, v)
        for k in self.deletes:
            self.parent.delete(k)
        self.writes.clear()
        self.deletes.clear()


class KVStore:
    """A single namespaced store view."""

    def __init__(self, layer, name: str = "", tracer_ref=None):
        self._layer = layer
        self._name = name
        # shared mutable holder [callable | None] owned by the MultiStore —
        # installing a tracer after KVStores were handed out still traces
        self._tracer_ref = tracer_ref if tracer_ref is not None else [None]

    def get(self, key: bytes) -> Optional[bytes]:
        return self._layer.get(key)

    def set(self, key: bytes, value: bytes) -> None:
        if not isinstance(key, bytes) or not isinstance(value, bytes):
            raise TypeError("keys and values must be bytes")
        tracer = self._tracer_ref[0]
        if tracer is not None:
            tracer("write", self._name, key, value)
        self._layer.set(key, value)

    def delete(self, key: bytes) -> None:
        tracer = self._tracer_ref[0]
        if tracer is not None:
            tracer("delete", self._name, key, None)
        self._layer.delete(key)

    def has(self, key: bytes) -> bool:
        return self._layer.has(key)

    def iterate(self, prefix: bytes = b"") -> Iterator[Tuple[bytes, bytes]]:
        """Deterministic (sorted) iteration over keys with the prefix."""
        for k in sorted(self._layer.keys()):
            if k.startswith(prefix):
                v = self._layer.get(k)
                if v is not None:
                    yield k, v


# forward diff: key -> new value (None = deleted)
Diff = Dict[bytes, Optional[bytes]]


class MultiStore:
    """Named substores + merkleized commit versioning + O(1) branching."""

    def __init__(self, store_names: List[str], history_keep: int = 256):
        self._names = list(store_names)
        self._layers: Dict[str, object] = {n: _DictLayer() for n in store_names}
        self._parent: Optional["MultiStore"] = None
        self._tracer_ref: List[Optional[object]] = [None]
        # merkle state: content-addressed nodes shared by every store tree
        self._nodes: Dict[bytes, bytes] = {}
        self._roots: Optional[Dict[str, bytes]] = None  # None = never built
        # committed history: (height, app_hash, {store: root}) + the values
        # each block overwrote, bounded to history_keep recent heights
        self._meta: List[Tuple[int, bytes, Dict[str, bytes]]] = []
        self._reverse_diffs: Dict[int, Dict[str, Diff]] = {}
        self.history_keep = history_keep
        self._gc_interval = 64
        self._commits_since_gc = 0
        self._last_height = 0
        self._persister: Optional[Callable] = None

    # --- wiring -----------------------------------------------------------

    def set_tracer(self, tracer) -> None:
        """Install a write tracer: tracer(op, store_name, key, value) fires
        on every set/delete through this store's views (the reference's
        SetCommitMultiStoreTracer role, app/app.go:243).  Pass None to
        remove.  Branches created AFTER installation inherit it."""
        self._tracer_ref[0] = tracer

    def set_persister(self, persister: Optional[Callable]) -> None:
        """persister(height, app_hash, roots, {store: forward_diff}) is
        called on every commit — the disk log's feed (state.disk)."""
        self._persister = persister

    def store(self, name: str) -> KVStore:
        if name not in self._layers:
            raise KeyError(f"unknown store {name!r}")
        return KVStore(self._layers[name], name, self._tracer_ref)

    @property
    def store_names(self) -> List[str]:
        return list(self._names)

    def ensure_store(self, name: str) -> None:
        """Mount a new substore (upgrade-time store additions)."""
        if name not in self._layers:
            self._names.append(name)
            self._layers[name] = _DictLayer()
            if self._roots is not None:
                self._roots[name] = EMPTY_ROOT

    # --- branching (CacheMultiStore semantics) ----------------------------

    def branch(self) -> "MultiStore":
        ms = MultiStore.__new__(MultiStore)
        ms._names = list(self._names)
        ms._layers = {n: _OverlayLayer(layer) for n, layer in self._layers.items()}
        ms._parent = self
        ms._tracer_ref = self._tracer_ref  # branches trace through the root
        ms._nodes = {}
        ms._roots = None
        ms._meta = []
        ms._reverse_diffs = {}
        ms.history_keep = self.history_keep
        ms._gc_interval = self._gc_interval
        ms._commits_since_gc = 0
        ms._last_height = self._last_height
        ms._persister = None
        return ms

    def write_back(self, branched: "MultiStore") -> None:
        """Apply a branch's writes to this store (the branch must have been
        created from this store)."""
        if branched._parent is not self:
            raise ValueError("write_back: branch does not belong to this store")
        for layer in branched._layers.values():
            layer.apply_to_parent()

    def overlay_delta(self) -> Dict[str, Tuple[Dict[bytes, bytes], Set[bytes]]]:
        """Snapshot of this BRANCH's pending writes: {store: (writes,
        deletes)} for every substore the branch touched.  The captured
        per-tx delta is what the parallel FilterTxs fold replays
        sequentially in priority order (state/app.py) — capture happens
        before write_back, which clears the overlay."""
        if self._parent is None:
            raise ValueError("overlay_delta: not a branched store")
        out: Dict[str, Tuple[Dict[bytes, bytes], Set[bytes]]] = {}
        for name, layer in self._layers.items():
            if layer.writes or layer.deletes:
                out[name] = (dict(layer.writes), set(layer.deletes))
        return out

    def apply_overlay_delta(
        self, delta: Dict[str, Tuple[Dict[bytes, bytes], Set[bytes]]]
    ) -> None:
        """Replay a captured overlay delta through this store's views
        (writes first, then deletes — apply_to_parent order)."""
        for name, (writes, deletes) in delta.items():
            st = self.store(name)
            for k, v in writes.items():
                st.set(k, v)
            for k in deletes:
                st.delete(k)

    # --- merkle sync ------------------------------------------------------

    def _sync_smt(self) -> Dict[str, bytes]:
        """Fold pending writes into the store trees; O(writes * log N)."""
        if self._parent is not None:
            raise ValueError("branched stores carry no merkle state")
        if self._roots is None:
            # first build (fresh store or state-sync import): everything
            self._roots = {}
            for name in self._names:
                layer = self._layers[name]
                self._roots[name] = merkle.smt_build(
                    self._nodes,
                    sorted(
                        (merkle.key_hash(k), merkle.value_hash(v))
                        for k, v in layer.data.items()
                    ),
                )
                layer.unsynced.clear()
            return self._roots
        for name in self._names:
            layer = self._layers[name]
            if not layer.unsynced:
                continue
            root = self._roots.get(name, EMPTY_ROOT)
            for k in sorted(layer.unsynced):
                kh = merkle.key_hash(k)
                v = layer.data.get(k)
                if v is None:
                    root = merkle.smt_delete(self._nodes, root, kh)
                else:
                    root = merkle.smt_update(
                        self._nodes, root, kh, merkle.value_hash(v)
                    )
            self._roots[name] = root
            layer.unsynced.clear()
        return self._roots

    def app_hash(self) -> bytes:
        """Root-of-store-roots over current state (pending writes
        included).  Idempotent; does not create a version."""
        return merkle.store_roots_hash(self._sync_smt())

    # --- commit / versions ------------------------------------------------

    def commit(self, height: int) -> bytes:
        if self._parent is not None:
            raise ValueError("cannot commit a branched store")
        if height <= self._last_height:
            raise ValueError(
                f"commit height {height} must be > last committed {self._last_height}"
            )
        roots = dict(self._sync_smt())
        ah = merkle.store_roots_hash(roots)
        forward: Dict[str, Diff] = {}
        reverse: Dict[str, Diff] = {}
        for name in self._names:
            layer = self._layers[name]
            if not layer.prev:
                continue
            reverse[name] = dict(layer.prev)
            forward[name] = {k: layer.data.get(k) for k in layer.prev}
            layer.prev.clear()
        self._meta.append((height, ah, roots))
        self._reverse_diffs[height] = reverse
        self._last_height = height
        if self._persister is not None:
            self._persister(height, ah, roots, forward)
        self._trim_history()
        return ah

    def _trim_history(self) -> None:
        if self.history_keep <= 0:
            return
        if len(self._meta) > self.history_keep:
            for h, _, _ in self._meta[: -self.history_keep]:
                self._reverse_diffs.pop(h, None)
            self._meta = self._meta[-self.history_keep:]
        self._commits_since_gc += 1
        if self._commits_since_gc >= self._gc_interval:
            self._gc_nodes()

    def _gc_nodes(self) -> None:
        """Drop merkle nodes unreachable from any retained root."""
        self._commits_since_gc = 0
        roots: Set[bytes] = set()
        if self._roots:
            roots.update(self._roots.values())
        for _, _, rts in self._meta:
            roots.update(rts.values())
        live = merkle.smt_reachable(self._nodes, roots)
        self._nodes = {h: e for h, e in self._nodes.items() if h in live}

    @property
    def last_height(self) -> int:
        return self._last_height

    def commit_at(self, height: int, app_hash: bytes) -> None:
        """Record the current state as the committed version at ``height``
        (snapshot restore: the store resumes as if it had committed there)."""
        if self._parent is not None:
            raise ValueError("cannot commit a branched store")
        roots = dict(self._sync_smt())
        for layer in self._layers.values():
            layer.prev.clear()
        self._meta.append((height, app_hash, roots))
        self._reverse_diffs[height] = {}
        self._last_height = height

    def prune(self, keep_recent: int) -> None:
        if keep_recent > 0 and len(self._meta) > keep_recent:
            for h, _, _ in self._meta[:-keep_recent]:
                self._reverse_diffs.pop(h, None)
            self._meta = self._meta[-keep_recent:]
        self._gc_nodes()

    def _meta_at(self, height: int) -> Tuple[int, bytes, Dict[str, bytes]]:
        for m in self._meta:
            if m[0] == height:
                return m
        raise KeyError(f"no committed version at height {height}")

    def load_height(self, height: int) -> None:
        """Roll the working state back to a committed version
        (app.LoadHeight parity, app/app.go:729) by unwinding the reverse
        diffs of every later block.  Only heights inside the retained
        history window can be loaded."""
        _, ah, roots = self._meta_at(height)
        # discard uncommitted writes first (restore pre-values)
        for layer in self._layers.values():
            for k, v in layer.prev.items():
                if v is None:
                    layer.data.pop(k, None)
                else:
                    layer.data[k] = v
            layer.prev.clear()
            layer.unsynced.clear()
        for h in sorted(
            (h for h in self._reverse_diffs if h > height), reverse=True
        ):
            for name, diff in self._reverse_diffs[h].items():
                layer = self._layers[name]
                for k, v in diff.items():
                    if v is None:
                        layer.data.pop(k, None)
                    else:
                        layer.data[k] = v
        for h in [h for h in self._reverse_diffs if h > height]:
            del self._reverse_diffs[h]
        self._meta = [m for m in self._meta if m[0] <= height]
        self._roots = dict(roots)
        self._last_height = height

    def committed_hash(self, height: int) -> bytes:
        return self._meta_at(height)[1]

    def committed_roots(self, height: int) -> Dict[str, bytes]:
        return dict(self._meta_at(height)[2])

    # --- height-pinned reads + proofs ------------------------------------

    def get_at(self, name: str, key: bytes, height: int) -> Optional[bytes]:
        """The value of ``key`` as of committed ``height`` (i.e. after
        block ``height`` executed), reconstructed from reverse diffs."""
        self._meta_at(height)  # raises if outside the retained window
        layer = self._layers[name]
        # last committed value = current, unless dirtied since last commit
        if key in layer.prev:
            value = layer.prev[key]
        else:
            value = layer.data.get(key)
        for h in sorted(
            (h for h in self._reverse_diffs if h > height), reverse=True
        ):
            diff = self._reverse_diffs[h].get(name)
            if diff is not None and key in diff:
                value = diff[key]
        return value

    def prove(self, name: str, key: bytes, height: Optional[int] = None) -> dict:
        """Membership / non-membership proof of ``key`` in store ``name``
        at committed ``height`` (default: latest).  The returned dict
        carries everything a client needs to verify against the block's
        app hash: the value, the sibling path, the terminal leaf, and ALL
        store roots (to recompute the root-of-store-roots).
        Verify with state.merkle.verify_query_proof."""
        if height is None:
            height = self._last_height
        h, ah, roots = self._meta_at(height)
        if name not in roots:
            raise KeyError(f"unknown store {name!r} at height {height}")
        value = self.get_at(name, key, height)
        siblings, leaf = merkle.smt_prove(
            self._nodes, roots[name], merkle.key_hash(key)
        )
        return {
            "height": h,
            "app_hash": ah.hex(),
            "store": name,
            "key": key.hex(),
            "value": value.hex() if value is not None else None,
            "siblings": [s.hex() for s in siblings],
            "leaf": [leaf[0].hex(), leaf[1].hex()] if leaf else None,
            "store_roots": {n: r.hex() for n, r in sorted(roots.items())},
        }

    # --- export / import (genesis + snapshots) ----------------------------

    def _flatten(self, name: str) -> Dict[bytes, bytes]:
        layer = self._layers[name]
        return {k: layer.get(k) for k in layer.keys()}

    def raw_state(self) -> Dict[str, Dict[bytes, bytes]]:
        """Bytes-level snapshot of all stores (disk checkpoint feed)."""
        return {n: dict(self._layers[n].data) for n in self._names}

    def export(self) -> Dict[str, Dict[str, str]]:
        """JSON-able dump of all stores (hex keys/values)."""
        return {
            n: {k.hex(): v.hex() for k, v in sorted(self._flatten(n).items())}
            for n in self._layers
        }

    @classmethod
    def import_state(cls, dump: Dict[str, Dict[str, str]]) -> "MultiStore":
        ms = cls(sorted(dump))
        for n, d in dump.items():
            ms._layers[n] = _DictLayer(
                {bytes.fromhex(k): bytes.fromhex(v) for k, v in d.items()}
            )
        return ms

    @classmethod
    def from_raw(cls, state: Dict[str, Dict[bytes, bytes]]) -> "MultiStore":
        """Adopt an already-decoded state map (disk-log recovery)."""
        ms = cls(sorted(state))
        for n, d in state.items():
            ms._layers[n] = _DictLayer(dict(d))
        return ms

    def apply_diff(self, diffs: Dict[str, Diff]) -> None:
        """Apply a forward diff (disk-log replay).  Writes go through the
        layers so merkle sync and the next commit's reverse diff see them."""
        for name, diff in diffs.items():
            self.ensure_store(name)
            layer = self._layers[name]
            for k, v in diff.items():
                if v is None:
                    layer.delete(k)
                else:
                    layer.set(k, v)
