"""State-sync snapshots: chunked export, restore, pruning.

Parity role: the reference snapshots app state every 1500 blocks into a
chunk store, keeps the 2 most recent, and restores joining nodes from them
(cmd/celestia-appd/cmd/root.go:227-243 snapshot store wiring,
app/default_overrides.go:296-297 interval/keep-recent defaults,
``celestia-appd snapshot`` command root.go:158-160).

Format: one directory per snapshot (``<height>-<format>``) holding
``metadata.json`` (height, app hash, chain id, app version, chunk count +
per-chunk sha256) and zlib-compressed chunk files of the JSON store dump.
Every chunk is integrity-checked on restore; the restored state must
reproduce the snapshot's recorded app hash or the restore is rejected.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

SNAPSHOT_FORMAT = 1
CHUNK_BYTES = 1 << 20

# DoS bounds on PEER-SUPPLIED snapshot data (ADVICE r5): the writer
# never produces a chunk above CHUNK_BYTES, so anything larger on the
# wire is hostile; the decompressed state payload is capped so a zlib
# bomb cannot exhaust memory before the app-hash check would fail.
MAX_WIRE_CHUNK_BYTES = CHUNK_BYTES
MAX_STATE_BYTES = 1 << 30  # 1 GiB decompressed, far above any real state


class SnapshotLimitError(ValueError):
    """A peer-supplied snapshot exceeded a resource bound (oversized
    chunk or decompression blow-up) — abort the sync and back off the
    peer; no honest snapshot trips these."""


@dataclass(frozen=True)
class SnapshotInfo:
    height: int
    format: int
    chunks: int
    app_hash: bytes
    chain_id: str
    app_version: int

    @property
    def dirname(self) -> str:
        return f"{self.height}-{self.format}"


class SnapshotStore:
    """File-backed snapshot store under one directory."""

    def __init__(self, root: str):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    # -- creation ------------------------------------------------------

    def create(self, app) -> SnapshotInfo:
        """Snapshot the app's latest committed state."""
        height = app.store.last_height
        app_hash = app.store.committed_hash(height)
        payload = zlib.compress(
            json.dumps(
                {"state": app.store.export(), "genesis_time_ns": app.genesis_time_ns}
            ).encode(),
            level=6,
        )
        chunks = [
            payload[i : i + CHUNK_BYTES]
            for i in range(0, max(len(payload), 1), CHUNK_BYTES)
        ]
        info = SnapshotInfo(
            height=height,
            format=SNAPSHOT_FORMAT,
            chunks=len(chunks),
            app_hash=app_hash,
            chain_id=app.chain_id,
            app_version=app.app_version,
        )
        tmp = self.root / (info.dirname + ".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        chunk_hashes = []
        for i, chunk in enumerate(chunks):
            (tmp / f"chunk-{i:04d}").write_bytes(chunk)
            chunk_hashes.append(hashlib.sha256(chunk).hexdigest())
        (tmp / "metadata.json").write_text(
            json.dumps(
                {
                    "height": info.height,
                    "format": info.format,
                    "chunks": info.chunks,
                    "chunk_hashes": chunk_hashes,
                    "app_hash": app_hash.hex(),
                    "chain_id": info.chain_id,
                    "app_version": info.app_version,
                }
            )
        )
        final = self.root / info.dirname
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        return info

    # -- listing / pruning ---------------------------------------------

    def _iter_metas(self) -> List[dict]:
        """All snapshot metadata dicts on disk, sorted by height — the
        single directory walk behind list() and list_wire().

        Only COMMITTED snapshots are listed: a ``*.tmp`` directory is a
        write in progress (save() publishes it atomically via rename) and
        must never surface as restorable — and racing its rename here is
        what made list() throw FileNotFoundError mid-state-sync.  A
        committed dir can still vanish between iterdir() and the read
        (concurrent prune()), so missing files are skipped, not fatal.
        """
        out = []
        for d in sorted(self.root.iterdir()):
            if d.suffix == ".tmp" or not d.is_dir():
                continue
            try:
                out.append(json.loads((d / "metadata.json").read_text()))
            except (FileNotFoundError, NotADirectoryError):
                continue  # pruned or re-staged between listing and read
        return sorted(out, key=lambda m: m["height"])

    def list(self) -> List[SnapshotInfo]:
        return [
            SnapshotInfo(
                height=m["height"],
                format=m["format"],
                chunks=m["chunks"],
                app_hash=bytes.fromhex(m["app_hash"]),
                chain_id=m["chain_id"],
                app_version=m["app_version"],
            )
            for m in self._iter_metas()
        ]

    def prune(self, keep_recent: int) -> int:
        snaps = self.list()
        dropped = 0
        for info in snaps[:-keep_recent] if keep_recent > 0 else []:
            shutil.rmtree(self.root / info.dirname, ignore_errors=True)
            dropped += 1
        return dropped

    # -- restore -------------------------------------------------------

    def latest(self) -> Optional[SnapshotInfo]:
        snaps = self.list()
        return snaps[-1] if snaps else None

    def load_state(self, info: SnapshotInfo) -> dict:
        """Read + verify chunks; returns {"state":…, "genesis_time_ns":…}."""
        d = self.root / info.dirname
        meta = json.loads((d / "metadata.json").read_text())
        chunks = [
            (d / f"chunk-{i:04d}").read_bytes() for i in range(info.chunks)
        ]
        return self.assemble(meta, chunks)

    # -- network serving (state-sync over gRPC) ------------------------

    def list_wire(self) -> List[dict]:
        """Snapshot metadata as JSON-safe dicts (incl. chunk hashes) for
        the SnapshotList RPC."""
        return self._iter_metas()

    def chunk_bytes(self, height: int, fmt: int, idx: int) -> Optional[bytes]:
        """One verified-on-write chunk, or None when absent."""
        d = self.root / f"{height}-{fmt}"
        path = d / f"chunk-{idx:04d}"
        if not path.exists():
            return None
        return path.read_bytes()

    @staticmethod
    def assemble(meta: dict, chunks: List[bytes]) -> dict:
        """Verify fetched chunks against the metadata hashes and decode
        the state payload — the restore half of the wire protocol.  The
        hashes only catch transfer corruption; TRUST comes from the app
        hash + commit-certificate checks done by the caller.  Resource
        bounds (chunk size, decompressed total) are enforced HERE so a
        malicious snapshot raises :class:`SnapshotLimitError` before it
        can exhaust memory."""
        if len(chunks) != meta["chunks"]:
            raise ValueError("chunk count mismatch")
        for i, chunk in enumerate(chunks):
            if len(chunk) > MAX_WIRE_CHUNK_BYTES:
                raise SnapshotLimitError(
                    f"snapshot chunk {i} is {len(chunk)} bytes "
                    f"(cap {MAX_WIRE_CHUNK_BYTES})"
                )
            got = hashlib.sha256(chunk).hexdigest()
            if got != meta["chunk_hashes"][i]:
                raise ValueError(f"snapshot chunk {i} corrupt in transfer")
        # capped streaming decompression: never materialize more than
        # MAX_STATE_BYTES of output no matter what the stream claims
        d = zlib.decompressobj()
        raw = d.decompress(b"".join(chunks), MAX_STATE_BYTES + 1)
        if len(raw) > MAX_STATE_BYTES:
            raise SnapshotLimitError(
                f"snapshot state exceeds the {MAX_STATE_BYTES}-byte "
                "decompression cap"
            )
        if d.unconsumed_tail or d.unused_data or not d.eof:
            raise ValueError("snapshot payload is not one zlib stream")
        return json.loads(raw)

    def restore_app(self, info: SnapshotInfo, **app_kwargs):
        """Build a fresh App from a snapshot; verifies the app hash."""
        from celestia_tpu_torch.state.app import App

        data = self.load_state(info)
        app = App.restore_from_snapshot(
            chain_id=info.chain_id,
            state=data["state"],
            height=info.height,
            expected_app_hash=info.app_hash,
            genesis_time_ns=data.get("genesis_time_ns", 0),
            **app_kwargs,
        )
        return app
