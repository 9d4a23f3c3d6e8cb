"""Append-only disk persistence: state diff log + block log with crash
recovery.

Role parity with the reference's LevelDB-backed stores — the commit
multistore's database, the block store and the tx index that let
`celestia-appd start` resume a chain from its data dir
(app/app.go:657-661 LoadLatestVersion;
cmd/celestia-appd/cmd/root.go:219-250 opens the home's data directory).
The format is this repo's own (designed for the append-only commit flow,
not a LevelDB port):

- ``state.log``: one STATE record per commit carrying the height, app
  hash, store roots and the FORWARD diff (key -> new value | delete) of
  that block.  Every ``checkpoint_interval`` commits a CHECKPOINT record
  with the full flattened state is appended, so recovery replays at most
  one interval of diffs instead of the whole chain.
- ``blocks.log``: one BLOCK record per block (header + txs + results +
  commit info), from which the block store and the tx index are rebuilt.

Each record is framed ``magic | type | u32 len | crc32 | payload``; a
torn tail write (crash mid-append) fails its CRC or length check and is
truncated on recovery, so a kill -9 at any instant loses at most the
block being written — never committed history.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

# the magic doubles as the format version: any layout change bumps it, so
# records written by an older layout fail the magic check and scan() stops
# there instead of misparsing (CTL1 -> CTL2: per-result events field)
_MAGIC = b"CTL2"
_T_STATE = 1
_T_CHECKPOINT = 2
_T_BLOCK = 3

_HEADER = struct.Struct("<4sBII")  # magic, type, payload_len, crc32


# --------------------------------------------------------------------------
# primitive codec (length-prefixed, deterministic)
# --------------------------------------------------------------------------


def _pb(out: List[bytes], b: bytes) -> None:
    out.append(struct.pack("<I", len(b)))
    out.append(b)


def _pi(out: List[bytes], i: int) -> None:
    out.append(struct.pack("<q", i))


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def bytes_(self) -> bytes:
        (n,) = struct.unpack_from("<I", self.buf, self.pos)
        self.pos += 4
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("truncated field")
        self.pos += n
        return b

    def int_(self) -> int:
        (i,) = struct.unpack_from("<q", self.buf, self.pos)
        self.pos += 8
        return i


def _encode_diffs(diffs: Dict[str, Dict[bytes, Optional[bytes]]]) -> List[bytes]:
    out: List[bytes] = []
    _pi(out, len(diffs))
    for name in sorted(diffs):
        _pb(out, name.encode())
        diff = diffs[name]
        _pi(out, len(diff))
        for k in sorted(diff):
            v = diff[k]
            _pb(out, k)
            if v is None:
                out.append(b"\x00")
            else:
                out.append(b"\x01")
                _pb(out, v)
    return out


def _decode_diffs(r: _Reader) -> Dict[str, Dict[bytes, Optional[bytes]]]:
    diffs: Dict[str, Dict[bytes, Optional[bytes]]] = {}
    for _ in range(r.int_()):
        name = r.bytes_().decode()
        diff: Dict[bytes, Optional[bytes]] = {}
        for _ in range(r.int_()):
            k = r.bytes_()
            flag = r.buf[r.pos : r.pos + 1]
            r.pos += 1
            diff[k] = r.bytes_() if flag == b"\x01" else None
        diffs[name] = diff
    return diffs


# --------------------------------------------------------------------------
# framed append-only log
# --------------------------------------------------------------------------


class _Log:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "ab")

    def append(self, rtype: int, payload: bytes) -> None:
        frame = _HEADER.pack(_MAGIC, rtype, len(payload), zlib.crc32(payload))
        self._f.write(frame + payload)
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()

    @staticmethod
    def scan(path: str) -> Iterator[Tuple[int, bytes, int]]:
        """Yield (type, payload, end_offset) for every intact record; stop
        at the first torn/corrupt frame.

        A log whose FIRST record carries an older format magic (CTL*)
        is a pre-upgrade data dir, not a torn tail — raise instead of
        silently treating the whole chain as garbage (recovery would
        otherwise truncate it to zero and reset to genesis)."""
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        while pos + _HEADER.size <= len(data):
            magic, rtype, n, crc = _HEADER.unpack_from(data, pos)
            if magic != _MAGIC:
                if pos == 0 and magic[:3] == _MAGIC[:3]:
                    raise RuntimeError(
                        f"{path} was written by log format "
                        f"{magic.decode(errors='replace')} but this build "
                        f"reads {_MAGIC.decode()}; refusing to destroy it "
                        "— migrate or move the data dir aside"
                    )
                break
            payload = data[pos + _HEADER.size : pos + _HEADER.size + n]
            if len(payload) != n or zlib.crc32(payload) != crc:
                break
            pos += _HEADER.size + n
            yield rtype, payload, pos

    @staticmethod
    def truncate_to(path: str, offset: int) -> None:
        """Drop a torn tail (crash mid-append)."""
        if os.path.exists(path) and os.path.getsize(path) > offset:
            with open(path, "r+b") as f:
                f.truncate(offset)


# --------------------------------------------------------------------------
# state log
# --------------------------------------------------------------------------


class StateLog:
    """Per-commit forward diffs + periodic full checkpoints."""

    def __init__(self, data_dir: str, checkpoint_interval: int = 500):
        self.path = os.path.join(data_dir, "state.log")
        self.checkpoint_interval = checkpoint_interval
        # resume the checkpoint cadence across restarts: count the diffs
        # already on disk since the last checkpoint, so a node restarted
        # every N < interval blocks still checkpoints eventually
        self._commits_since_checkpoint = 0
        for rtype, _, _ in _Log.scan(self.path):
            if rtype == _T_CHECKPOINT:
                self._commits_since_checkpoint = 0
            else:
                self._commits_since_checkpoint += 1
        self._log = _Log(self.path)

    def append_commit(
        self,
        height: int,
        app_hash: bytes,
        roots: Dict[str, bytes],
        forward: Dict[str, Dict[bytes, Optional[bytes]]],
        full_state_fn=None,
    ) -> None:
        """full_state_fn() -> {store: {key: value}} is only invoked when
        this commit lands on a checkpoint boundary (so the caller doesn't
        flatten state every block)."""
        out: List[bytes] = []
        _pi(out, height)
        _pb(out, app_hash)
        _pi(out, len(roots))
        for name in sorted(roots):
            _pb(out, name.encode())
            _pb(out, roots[name])
        out.extend(_encode_diffs(forward))
        self._log.append(_T_STATE, b"".join(out))
        self._commits_since_checkpoint += 1
        if (
            full_state_fn is not None
            and self._commits_since_checkpoint >= self.checkpoint_interval
        ):
            self.append_checkpoint(height, app_hash, full_state_fn())

    def append_checkpoint(
        self,
        height: int,
        app_hash: bytes,
        state: Dict[str, Dict[bytes, bytes]],
    ) -> None:
        out: List[bytes] = []
        _pi(out, height)
        _pb(out, app_hash)
        out.extend(
            _encode_diffs({n: dict(d) for n, d in state.items()})
        )
        self._log.append(_T_CHECKPOINT, b"".join(out))
        self._commits_since_checkpoint = 0

    def close(self) -> None:
        self._log.close()

    @classmethod
    def recover(
        cls, data_dir: str, up_to: Optional[int] = None
    ) -> Optional[Tuple[Dict[str, Dict[bytes, bytes]], int, bytes]]:
        """Rebuild (state, last_height, last_app_hash) from the log: the
        latest checkpoint, then every later diff.  Returns None when no
        intact record exists.  Truncates any torn tail.

        ``up_to`` ignores records beyond that height — used when the block
        log is one behind the state log (crash between the state fsync and
        the block fsync), so the node restarts on a consistent pair.
        """
        path = os.path.join(data_dir, "state.log")
        records: List[Tuple[int, bytes]] = []
        end = 0
        for rtype, payload, off in _Log.scan(path):
            height = _Reader(payload).int_()
            if up_to is not None and height > up_to:
                continue
            records.append((rtype, payload))
            end = off
        _Log.truncate_to(path, end)
        if not records:
            return None
        # start from the last checkpoint (if any)
        start = 0
        for i in range(len(records) - 1, -1, -1):
            if records[i][0] == _T_CHECKPOINT:
                start = i
                break
        state: Dict[str, Dict[bytes, bytes]] = {}
        last_height = 0
        last_hash = b""
        for rtype, payload in records[start:]:
            r = _Reader(payload)
            height = r.int_()
            app_hash = r.bytes_()
            if rtype == _T_CHECKPOINT:
                state = {
                    n: {k: v for k, v in d.items() if v is not None}
                    for n, d in _decode_diffs(r).items()
                }
            else:
                n_roots = r.int_()
                for _ in range(n_roots):
                    r.bytes_()
                    r.bytes_()
                for name, diff in _decode_diffs(r).items():
                    dst = state.setdefault(name, {})
                    for k, v in diff.items():
                        if v is None:
                            dst.pop(k, None)
                        else:
                            dst[k] = v
            last_height, last_hash = height, app_hash
        return state, last_height, last_hash


# --------------------------------------------------------------------------
# block log
# --------------------------------------------------------------------------


class BlockLog:
    """Append-only block store; rebuilds the block list + tx index."""

    def __init__(self, data_dir: str):
        self.path = os.path.join(data_dir, "blocks.log")
        self._log = _Log(self.path)

    def append_block(self, block) -> None:
        """block: node.testnode.Block (imported lazily to avoid cycles)."""
        from celestia_tpu_torch.state.app import jsonable_events

        h = block.header
        out: List[bytes] = []
        _pi(out, h.height)
        _pi(out, h.time_ns)
        _pb(out, h.chain_id.encode())
        _pi(out, h.app_version)
        _pb(out, h.data_hash)
        _pb(out, h.app_hash)
        _pi(out, h.square_size)
        _pb(out, block.proposer or b"")
        votes = block.votes or []
        _pi(out, len(votes))
        for addr, signed in votes:
            _pb(out, addr)
            out.append(b"\x01" if signed else b"\x00")
        _pi(out, len(block.txs))
        for t in block.txs:
            _pb(out, t)
        results = block.tx_results or []
        _pi(out, len(results))
        for res in results:
            _pi(out, res.code)
            _pb(out, res.log.encode())
            _pi(out, res.gas_wanted)
            _pi(out, res.gas_used)
            _pb(out, json.dumps(jsonable_events(res.events)).encode())
        self._log.append(_T_BLOCK, b"".join(out))

    def close(self) -> None:
        self._log.close()

    @classmethod
    def recover(cls, data_dir: str) -> List[object]:
        """All intact blocks, in order; truncates a torn tail."""
        from celestia_tpu_torch.state.app import TxResult
        from celestia_tpu_torch.state.consensus import Block, BlockHeader

        path = os.path.join(data_dir, "blocks.log")
        blocks: List[object] = []
        end = 0
        for rtype, payload, off in _Log.scan(path):
            end = off
            if rtype != _T_BLOCK:
                continue
            r = _Reader(payload)
            header = BlockHeader(
                height=r.int_(),
                time_ns=r.int_(),
                chain_id=r.bytes_().decode(),
                app_version=r.int_(),
                data_hash=r.bytes_(),
                app_hash=r.bytes_(),
                square_size=r.int_(),
            )
            proposer = r.bytes_()
            votes: List[Tuple[bytes, bool]] = []
            for _ in range(r.int_()):
                addr = r.bytes_()
                flag = r.buf[r.pos : r.pos + 1]
                r.pos += 1
                votes.append((addr, flag == b"\x01"))
            txs = [r.bytes_() for _ in range(r.int_())]
            results = [
                TxResult(
                    code=r.int_(),
                    log=r.bytes_().decode(),
                    gas_wanted=r.int_(),
                    gas_used=r.int_(),
                    events=json.loads(r.bytes_()),
                )
                for _ in range(r.int_())
            ]
            blocks.append(
                Block(header, txs, results, proposer, votes or None)
            )
        _Log.truncate_to(path, end)
        return blocks
