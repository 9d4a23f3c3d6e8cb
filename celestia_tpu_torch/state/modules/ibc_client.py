"""IBC light-client layer: trustless packet verification (VERDICT r2 #4).

The round-2 stack moved packets on relayer honesty.  This module adds the
trust machinery the reference gets from ibc-go core + 07-tendermint
clients (app/app.go:339-358):

- ``LightClient`` tracks a counterparty chain's validator set and a map
  height -> ``ConsensusState`` (state root + time).  It advances ONLY on
  a header whose BFT commit certificate verifies: >= 2/3 of the tracked
  power signed precommits over the header's block id
  (node/bft.py vote signatures), and the block id commits to
  ``prev_app_hash`` — so the certificate proves the counterparty's state
  root exactly the way a Tendermint header's AppHash is proven.
- ``Connection`` binds channels to a client (the ICS-3 role, condensed:
  the handshake's proof obligations are the membership checks below).
- Verified packet receive / acknowledgement: the relayer presents a
  merkle membership proof of the packet commitment (or ack) in the
  counterparty's "ibc" store at a proven height; the proof is checked
  against the light client's consensus state with
  state.merkle.verify_query_proof — the relayer is untrusted end to end.

Height convention (Tendermint's): the consensus state recorded at header
height H carries the state root app_hash(H-1); a proof generated against
the store committed at height G therefore verifies with the consensus
state at G+1.

Limitation (documented, round-3 scope): the tracked validator set is
fixed at client creation — valset rotation needs the next-valset hash
committed in the block id, which the payload does not carry yet.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from celestia_tpu_torch.state.consensus import (
    PRECOMMIT,
    Vote,
    block_id_of,
    vote_sign_bytes,
)
from celestia_tpu_torch.state import merkle
from celestia_tpu_torch.utils.secp256k1 import PublicKey


class ClientError(ValueError):
    pass


# key hashes are 32 bytes, so a valid SMT path never exceeds 256 levels;
# anything longer is a malformed proof, not a deeper tree
_MAX_PROOF_DEPTH = 256


def _checked_proof_verify(proof: dict, root: bytes) -> bool:
    """Run merkle.verify_query_proof on untrusted relayer input, keeping
    the ClientError contract: malformed proofs (bad hex, missing fields,
    oversized sibling paths) FAIL verification instead of escaping as
    ValueError/IndexError/KeyError the callers don't catch."""
    try:
        if len(proof.get("siblings", ())) > _MAX_PROOF_DEPTH:
            raise ClientError(
                f"proof sibling path exceeds {_MAX_PROOF_DEPTH} levels"
            )
        return merkle.verify_query_proof(proof, root)
    except ClientError:
        raise
    except (ValueError, IndexError, KeyError, TypeError, AttributeError) as e:
        raise ClientError(f"malformed proof: {e}") from e


@dataclass(frozen=True)
class ConsensusState:
    root: bytes  # the counterparty app hash proofs verify against
    time_ns: int


class LightClient:
    """07-tendermint analogue over the BFT engine's vote format.

    With a store attached (via ConnectionKeeper), every mutation — new
    consensus states, latest_height, and crucially the misbehaviour
    ``frozen`` flag — is mirrored into merkleized state so a
    disk/snapshot restore brings the client back EXACTLY as it was: a
    client frozen for a proven fork must never come back unfrozen
    (ibc-go persists ClientState/ConsensusState in the ibc store the
    same way)."""

    def __init__(
        self,
        client_id: str,
        chain_id: str,
        validators: Dict[bytes, int],  # operator address -> power
        pubkeys: Dict[bytes, bytes],  # operator address -> 33B compressed
        store=None,
    ):
        if not validators:
            raise ClientError("empty validator set")
        self.client_id = client_id
        self.chain_id = chain_id
        self.validators = dict(validators)
        self.pubkeys = dict(pubkeys)
        self.total_power = sum(validators.values())
        self.consensus_states: Dict[int, ConsensusState] = {}
        self.latest_height = 0
        self.frozen = False
        self.store = store

    # -- persistence ----------------------------------------------------

    def attach_store(self, store) -> None:
        """Mirror the full current state into the given KVStore and keep
        mirroring on every future mutation."""
        self.store = store
        self._persist_identity()
        self._persist_meta()
        for h in self.consensus_states:
            self._persist_consensus(h)

    def _persist_identity(self) -> None:
        """The immutable part — chain id, valset, pubkeys — written once
        at client creation, NOT on every update (the valset can be large
        and never changes for this client's lifetime)."""
        if self.store is None:
            return
        self.store.set(
            client_state_key(self.client_id),
            json.dumps(
                {
                    "chain_id": self.chain_id,
                    "validators": {
                        a.hex(): p for a, p in self.validators.items()
                    },
                    "pubkeys": {
                        a.hex(): pk.hex() for a, pk in self.pubkeys.items()
                    },
                },
                sort_keys=True,
            ).encode(),
        )

    def _persist_meta(self) -> None:
        """The mutable part — frozen flag + latest height — a small O(1)
        record rewritten on every update."""
        if self.store is None:
            return
        self.store.set(
            client_meta_key(self.client_id),
            json.dumps(
                {"frozen": self.frozen, "latest_height": self.latest_height},
                sort_keys=True,
            ).encode(),
        )

    def _persist_consensus(self, height: int) -> None:
        if self.store is None:
            return
        cs = self.consensus_states[height]
        self.store.set(
            consensus_state_store_key(self.client_id, height),
            json.dumps(
                {"root": cs.root.hex(), "time_ns": cs.time_ns},
                sort_keys=True,
            ).encode(),
        )

    @classmethod
    def from_state(cls, client_id: str, d: dict) -> "LightClient":
        """Rebuild a client from its persisted identity record (meta and
        consensus states are rehydrated separately by the keeper)."""
        return cls(
            client_id,
            d["chain_id"],
            {bytes.fromhex(a): int(p) for a, p in d["validators"].items()},
            {
                bytes.fromhex(a): bytes.fromhex(pk)
                for a, pk in d["pubkeys"].items()
            },
        )

    def apply_meta(self, d: dict) -> None:
        self.frozen = bool(d["frozen"])
        self.latest_height = int(d["latest_height"])

    # -- header verification -------------------------------------------

    def update(self, header: dict, precommits: List[dict]) -> int:
        """Verify a (header, commit certificate) pair and record the
        consensus state it proves.  header = BlockPayload.header_fields()
        — the block-id preimage without txs; precommits = Vote wire
        dicts.  Returns the header height.  The caller (relayer) is
        untrusted: everything is checked against the tracked valset."""
        if self.frozen:
            raise ClientError(f"client {self.client_id} is frozen")
        try:
            height = int(header["height"])
            time_ns = int(header["time_ns"])
            square_size = int(header["square_size"])
            # _varint loops forever on negative ints — malformed, not fatal
            if height <= 0 or time_ns < 0 or square_size < 0:
                raise ClientError("header fields out of range")
            prev_app_hash = bytes.fromhex(header["prev_app_hash"])
            block_id = block_id_of(
                height,
                time_ns,
                square_size,
                bytes.fromhex(header["data_root"]),
                bytes.fromhex(header["proposer"]),
                bytes.fromhex(header["last_commit_digest"]),
                prev_app_hash,
            )
            votes = [Vote.from_wire(v) for v in precommits]
        except ClientError:
            raise
        except (ValueError, KeyError, TypeError, AttributeError) as e:
            raise ClientError(f"malformed header/certificate: {e}") from e
        if not votes:
            raise ClientError("empty certificate: below 2/3 power")
        rounds = {v.round for v in votes}
        if len(rounds) != 1:
            raise ClientError("commit certificate mixes rounds")
        seen = set()
        power = 0
        for v in votes:
            if v.vtype != PRECOMMIT or v.height != height:
                raise ClientError("certificate vote is not for this header")
            if v.block_id != block_id:
                raise ClientError("certificate vote is for a different block")
            if v.validator in seen:
                raise ClientError("duplicate validator in certificate")
            seen.add(v.validator)
            vp = self.validators.get(v.validator)
            pk = self.pubkeys.get(v.validator)
            if not vp or pk is None:
                raise ClientError("unknown validator in certificate")
            digest = vote_sign_bytes(
                self.chain_id, v.height, v.round, v.vtype, v.block_id
            )
            if not PublicKey.from_compressed(pk).verify(digest, v.signature):
                raise ClientError("certificate signature does not verify")
            power += vp
        if power * 3 < self.total_power * 2:
            raise ClientError(
                f"certificate power {power} below 2/3 of {self.total_power}"
            )
        # misbehaviour: two CERTIFIED headers at one height with different
        # roots means the counterparty valset double-signed — freeze the
        # client permanently (07-tendermint freezes the same way); a
        # relayer must never be able to pick which fork proofs verify on
        existing = self.consensus_states.get(height)
        if existing is not None and existing.root != prev_app_hash:
            self.frozen = True
            self._persist_meta()  # the freeze must survive a restart
            raise ClientError(
                f"misbehaviour: conflicting certified headers at height "
                f"{height}; client {self.client_id} frozen"
            )
        # Tendermint semantics: the header at H proves app_hash(H-1);
        # record it as the consensus state AT H
        self.consensus_states[height] = ConsensusState(
            root=prev_app_hash, time_ns=time_ns
        )
        self.latest_height = max(self.latest_height, height)
        self._persist_consensus(height)
        self._persist_meta()
        return height

    # -- membership verification ---------------------------------------

    def verify_membership(
        self, proof_height: int, key: bytes, value: bytes, proof: dict
    ) -> None:
        """Raise ClientError unless ``proof`` shows ("ibc", key) == value
        in the counterparty state the consensus state at proof_height
        commits to.  The proof's own claimed key/value/store are checked
        AGAINST THE CALLER'S expectation — a relayer substituting a proof
        of some other key fails here."""
        cs = self.consensus_states.get(proof_height)
        if cs is None:
            raise ClientError(
                f"no consensus state at height {proof_height} "
                f"(client {self.client_id})"
            )
        try:
            if proof.get("store") != "ibc":
                raise ClientError("proof is not for the ibc store")
            if bytes.fromhex(proof["key"]) != key:
                raise ClientError("proof key does not match the packet")
            if proof["value"] is None or bytes.fromhex(proof["value"]) != (
                value
            ):
                raise ClientError("proof value does not match the packet")
        except ClientError:
            raise
        except (ValueError, KeyError, TypeError, AttributeError) as e:
            raise ClientError(f"malformed proof: {e}") from e
        if not _checked_proof_verify(proof, cs.root):
            raise ClientError(
                "membership proof does not verify against the consensus state"
            )

    def verify_non_membership(
        self, proof_height: int, key: bytes, proof: dict
    ) -> None:
        """Absence proof (timeouts: the counterparty never wrote a
        receipt for the packet)."""
        cs = self.consensus_states.get(proof_height)
        if cs is None:
            raise ClientError(f"no consensus state at height {proof_height}")
        try:
            if proof.get("store") != "ibc":
                raise ClientError("proof is not for the ibc store")
            if bytes.fromhex(proof["key"]) != key:
                raise ClientError("proof key does not match")
            if proof["value"] is not None:
                raise ClientError("expected an absence proof")
        except ClientError:
            raise
        except (ValueError, KeyError, TypeError, AttributeError) as e:
            raise ClientError(f"malformed proof: {e}") from e
        if not _checked_proof_verify(proof, cs.root):
            raise ClientError(
                "absence proof does not verify against the consensus state"
            )


@dataclass
class Connection:
    """ICS-3 condensed: a named binding of channels to a light client."""

    connection_id: str
    client: LightClient
    counterparty_connection: str = ""


class ConnectionKeeper:
    """Client/connection/binding registry.  With a store attached (the
    app's "ibc" substore, shared with ChannelKeeper under disjoint key
    prefixes) everything here is mirrored to merkleized state and
    rehydrated after a disk/snapshot restore — clients, their consensus
    states and frozen flags, connections, and channel bindings all
    survive a restart alongside the receipts/commitments the channel
    keeper already persists."""

    def __init__(self, store=None):
        self.store = store
        self.clients: Dict[str, LightClient] = {}
        self.connections: Dict[str, Connection] = {}
        # channel_id -> connection_id: which client secures which channel
        self.channel_bindings: Dict[str, str] = {}

    def rehydrate(self) -> None:
        """Rebuild clients, connections and bindings from the store."""
        if self.store is None:
            return
        consensus_rows = []
        meta_rows: Dict[str, dict] = {}
        connection_rows: Dict[str, dict] = {}
        for k, v in self.store.iterate():
            parts = k.decode().split("/")
            if parts[0] == "clients" and len(parts) == 3 and (
                parts[2] == "state"
            ):
                self.clients[parts[1]] = LightClient.from_state(
                    parts[1], json.loads(v)
                )
            elif parts[0] == "clients" and len(parts) == 3 and (
                parts[2] == "meta"
            ):
                meta_rows[parts[1]] = json.loads(v)
            elif parts[0] == "clients" and len(parts) == 4 and (
                parts[2] == "consensus"
            ):
                consensus_rows.append((parts[1], int(parts[3]), json.loads(v)))
            elif parts[0] == "connections" and len(parts) == 2:
                connection_rows[parts[1]] = json.loads(v)
            elif parts[0] == "channelclients" and len(parts) == 2:
                self.channel_bindings[parts[1]] = v.decode()
        for cid, meta in meta_rows.items():
            client = self.clients.get(cid)
            if client is not None:
                client.apply_meta(meta)
        for cid, height, d in consensus_rows:
            client = self.clients.get(cid)
            if client is not None:
                client.consensus_states[height] = ConsensusState(
                    root=bytes.fromhex(d["root"]), time_ns=int(d["time_ns"])
                )
        for client in self.clients.values():
            client.store = self.store  # future mutations keep mirroring
        for conn_id, d in connection_rows.items():
            client = self.clients.get(d["client_id"])
            if client is not None:
                self.connections[conn_id] = Connection(
                    conn_id, client, d.get("counterparty_connection", "")
                )

    def create_client(self, client: LightClient) -> None:
        if client.client_id in self.clients:
            raise ClientError(f"client {client.client_id} exists")
        self.clients[client.client_id] = client
        if self.store is not None:
            client.attach_store(self.store)

    def open_connection(
        self, connection_id: str, client_id: str,
        counterparty_connection: str = "",
    ) -> Connection:
        client = self.clients.get(client_id)
        if client is None:
            raise ClientError(f"unknown client {client_id}")
        conn = Connection(connection_id, client, counterparty_connection)
        self.connections[connection_id] = conn
        if self.store is not None:
            self.store.set(
                connection_store_key(connection_id),
                json.dumps(
                    {
                        "client_id": client_id,
                        "counterparty_connection": counterparty_connection,
                    },
                    sort_keys=True,
                ).encode(),
            )
        return conn

    def bind_channel(self, channel_id: str, connection_id: str) -> None:
        if connection_id not in self.connections:
            raise ClientError(f"unknown connection {connection_id}")
        self.channel_bindings[channel_id] = connection_id
        if self.store is not None:
            self.store.set(
                channel_binding_key(channel_id), connection_id.encode()
            )

    def client_for_channel(self, channel_id: str) -> Optional[LightClient]:
        conn_id = self.channel_bindings.get(channel_id)
        if conn_id is None:
            return None
        conn = self.connections.get(conn_id)
        return conn.client if conn is not None else None


# -- store key layout (what proofs point at) ------------------------------


def client_state_key(client_id: str) -> bytes:
    return f"clients/{client_id}/state".encode()


def client_meta_key(client_id: str) -> bytes:
    return f"clients/{client_id}/meta".encode()


def consensus_state_store_key(client_id: str, height: int) -> bytes:
    return f"clients/{client_id}/consensus/{height}".encode()


def connection_store_key(connection_id: str) -> bytes:
    return f"connections/{connection_id}".encode()


def channel_binding_key(channel_id: str) -> bytes:
    return f"channelclients/{channel_id}".encode()


def commitment_key(channel_id: str, seq: int) -> bytes:
    return f"commitments/{channel_id}/{seq}".encode()


def nextseq_key(channel_id: str) -> bytes:
    return f"nextseq/{channel_id}".encode()


def timedout_key(channel_id: str, seq: int) -> bytes:
    return f"timedout/{channel_id}/{seq}".encode()


def packet_commitment(data: bytes, timeout_height: int) -> bytes:
    """What `commitments/{channel}/{seq}` stores: covers the data AND the
    timeout, so a relayer can neither tamper the payload nor stretch the
    packet's deliverability window."""
    return hashlib.sha256(
        timeout_height.to_bytes(8, "big") + data
    ).digest()


def ack_key(channel_id: str, seq: int) -> bytes:
    return f"acks/{channel_id}/{seq}".encode()


def receipt_key(channel_id: str, seq: int) -> bytes:
    return f"receipts/{channel_id}/{seq}".encode()


def channel_key(channel_id: str) -> bytes:
    return f"channels/{channel_id}".encode()


def ack_bytes(ack) -> bytes:
    """Canonical acknowledgement encoding (what the ack commitment
    hashes)."""
    return json.dumps(
        {"success": bool(ack.success), "error": ack.error or ""},
        sort_keys=True,
    ).encode()
