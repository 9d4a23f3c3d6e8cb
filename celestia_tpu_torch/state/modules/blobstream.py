"""x/blobstream (QGB): EVM-bridge attestations over data roots.

Parity with x/blobstream/: the EndBlocker emits Valset
attestations on >5% power change or unbonding (abci.go:86-130) and
DataCommitment attestations every DataCommitmentWindow blocks
(abci.go:37-83, handleDataCommitmentRequest); attestations older than
~3 weeks are pruned (abci.go:20,134+); validators register EVM addresses
(MsgRegisterEVMAddress); the data-commitment root is a merkle root over the
block data roots in the window (served to EVM light clients).  Staking hooks
request a valset when validators are created or begin unbonding
(keeper/hooks.go:24-43).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from celestia_tpu_torch.state.params import ParamsKeeper
from celestia_tpu_torch.state.staking import StakingKeeper
from celestia_tpu_torch.state.store import KVStore
from celestia_tpu_torch.ops.nmt import rfc6962_root_np

_ATTESTATION_PREFIX = b"att/"
_LATEST_NONCE_KEY = b"latest_nonce"
_LAST_PRUNED_KEY = b"last_pruned_nonce"
_EVM_PREFIX = b"evm/"
_VALSET_REQUEST_KEY = b"valset_requested"

ATTESTATION_EXPIRY_NS = 3 * 7 * 24 * 3600 * 10**9  # 3 weeks
SIGNIFICANT_POWER_DIFF_PPM = 50_000  # 5%


@dataclass(frozen=True)
class BridgeValidator:
    evm_address: bytes
    power: int


@dataclass(frozen=True)
class Valset:
    nonce: int
    members: Tuple[BridgeValidator, ...]
    height: int
    time_ns: int

    TYPE = "valset"

    def to_json(self) -> dict:
        return {
            "type": self.TYPE,
            "nonce": self.nonce,
            "members": [
                {"evm_address": m.evm_address.hex(), "power": m.power}
                for m in self.members
            ],
            "height": self.height,
            "time_ns": self.time_ns,
        }


@dataclass(frozen=True)
class DataCommitment:
    nonce: int
    begin_block: int  # inclusive
    end_block: int  # exclusive
    data_root_tuple_root: bytes  # merkle over (height, dataRoot) tuples
    height: int
    time_ns: int

    TYPE = "data_commitment"

    def to_json(self) -> dict:
        return {
            "type": self.TYPE,
            "nonce": self.nonce,
            "begin_block": self.begin_block,
            "end_block": self.end_block,
            "data_root_tuple_root": self.data_root_tuple_root.hex(),
            "height": self.height,
            "time_ns": self.time_ns,
        }


def data_root_tuple_root(heights_and_roots: List[Tuple[int, bytes]]) -> bytes:
    """Merkle root over (height, data_root) tuples — what the EVM bridge
    verifies inclusion against (x/blobstream query server's root)."""
    leaves = [h.to_bytes(8, "big") + root for h, root in heights_and_roots]
    return rfc6962_root_np(leaves).tobytes()


class BlobstreamKeeper:
    def __init__(self, store: KVStore, staking: StakingKeeper, params: ParamsKeeper):
        self.store = store
        self.staking = staking
        self.params = params
        staking.hooks_after_validator_created.append(self._request_valset)
        staking.hooks_after_unbonding_initiated.append(self._request_valset)

    # --- EVM address registry ---------------------------------------------

    def register_evm_address(self, validator: bytes, evm_address: bytes) -> None:
        if self.staking.validator(validator) is None:
            raise ValueError(f"unknown validator {validator.hex()}")
        if len(evm_address) != 20:
            raise ValueError("EVM address must be 20 bytes")
        self.store.set(_EVM_PREFIX + validator, evm_address)

    def evm_address(self, validator: bytes) -> bytes:
        """Registered address, or a deterministic default derived from the
        validator address (reference defaults to a derived address)."""
        raw = self.store.get(_EVM_PREFIX + validator)
        if raw is not None:
            return raw
        return hashlib.sha256(b"default-evm/" + validator).digest()[:20]

    # --- attestations -----------------------------------------------------

    def latest_nonce(self) -> int:
        raw = self.store.get(_LATEST_NONCE_KEY)
        return int.from_bytes(raw, "big") if raw else 0

    def _next_nonce(self) -> int:
        n = self.latest_nonce() + 1
        self.store.set(_LATEST_NONCE_KEY, n.to_bytes(8, "big"))
        return n

    def _store_attestation(self, nonce: int, att: dict) -> None:
        self.store.set(
            _ATTESTATION_PREFIX + nonce.to_bytes(8, "big"),
            json.dumps(att, sort_keys=True).encode(),
        )

    def attestation(self, nonce: int) -> Optional[dict]:
        raw = self.store.get(_ATTESTATION_PREFIX + nonce.to_bytes(8, "big"))
        return json.loads(raw) if raw else None

    def attestations(self) -> List[dict]:
        return [
            json.loads(v) for _, v in self.store.iterate(_ATTESTATION_PREFIX)
        ]

    def _current_bridge_valset(self) -> Tuple[BridgeValidator, ...]:
        members = []
        for v in self.staking.bonded_validators():
            members.append(BridgeValidator(self.evm_address(v.operator), v.power))
        return tuple(sorted(members, key=lambda m: (-m.power, m.evm_address)))

    def _request_valset(self, _operator: bytes) -> None:
        self.store.set(_VALSET_REQUEST_KEY, b"\x01")

    def _last_valset(self) -> Optional[dict]:
        for att in reversed(self.attestations()):
            if att.get("type") == Valset.TYPE:
                return att
        return None

    @staticmethod
    def _power_diff_ppm(old_members: List[dict], new: Tuple[BridgeValidator, ...]) -> int:
        """Normalized power-vector L1 distance in ppm (abci.go power diff).

        Integer arithmetic only — this feeds a consensus decision (whether a
        valset attestation is emitted), so it must be bit-identical on every
        validator.
        """
        old_total = sum(m["power"] for m in old_members) or 1
        new_total = sum(m.power for m in new) or 1
        old_map = {m["evm_address"]: m["power"] for m in old_members}
        new_map = {m.evm_address.hex(): m.power for m in new}
        keys = set(old_map) | set(new_map)
        num = sum(
            abs(old_map.get(k, 0) * new_total - new_map.get(k, 0) * old_total)
            for k in keys
        )
        return num * 1_000_000 // (2 * old_total * new_total)

    def end_blocker(self, height: int, time_ns: int) -> List[dict]:
        """abci.go:29-35: emit valset/data-commitment attestations, prune."""
        emitted: List[dict] = []
        # -- valset (abci.go:86-130)
        current = self._current_bridge_valset()
        last = self._last_valset()
        requested = self.store.get(_VALSET_REQUEST_KEY) is not None
        need = False
        if current:
            if last is None or requested:
                need = True
            elif self._power_diff_ppm(last["members"], current) > SIGNIFICANT_POWER_DIFF_PPM:
                need = True
        if need:
            vs = Valset(self._next_nonce(), current, height, time_ns)
            self._store_attestation(vs.nonce, vs.to_json())
            emitted.append(vs.to_json())
            self.store.delete(_VALSET_REQUEST_KEY)
        # -- data commitment (abci.go:37-83): window boundary
        window = self.params.get("blobstream", "DataCommitmentWindow", 400)
        if height > 0 and height % window == 0:
            begin = height - window + 1
            end = height + 1
            dc_root = self._window_root(begin, end)
            dc = DataCommitment(self._next_nonce(), begin, end, dc_root, height, time_ns)
            self._store_attestation(dc.nonce, dc.to_json())
            emitted.append(dc.to_json())
        # -- prune expired (3 weeks)
        self._prune(time_ns)
        return emitted

    # data roots per height are recorded by the app after each block
    _DATA_ROOT_PREFIX = b"droot/"

    def record_data_root(self, height: int, data_root: bytes) -> None:
        self.store.set(self._DATA_ROOT_PREFIX + height.to_bytes(8, "big"), data_root)

    def data_root(self, height: int) -> Optional[bytes]:
        return self.store.get(self._DATA_ROOT_PREFIX + height.to_bytes(8, "big"))

    def _window_root(self, begin: int, end: int) -> bytes:
        tuples = []
        for h in range(begin, end):
            root = self.data_root(h)
            if root is None:
                root = b"\x00" * 32
            tuples.append((h, root))
        return data_root_tuple_root(tuples)

    # --- query/verify surface (x/blobstream query server + client/verify.go)

    def data_commitment_for_height(self, height: int) -> Optional[dict]:
        """DataCommitmentRangeForHeight parity
        (keeper/query_data_commitment.go): the DataCommitment attestation
        whose [begin_block, end_block) window covers ``height``."""
        for att in self.attestations():
            if att.get("type") != DataCommitment.TYPE:
                continue
            if att["begin_block"] <= height < att["end_block"]:
                return att
        return None

    def data_root_inclusion_proof(
        self, height: int, begin: int, end: int
    ) -> dict:
        """Merkle proof that block ``height``'s (height, data_root) tuple
        is a leaf of the [begin, end) window's data-root tuple root — the
        proof an EVM relayer posts against the Blobstream contract
        (client/verify.go DataRootInclusionProof role).  Serialized
        JSON-safe; verify with client/blobstream.verify_data_root_inclusion."""
        from celestia_tpu_torch.da.proof import merkle_proof

        if not (begin <= height < end):
            raise ValueError(
                f"height {height} outside the window [{begin}, {end})"
            )
        # only ATTESTED windows are provable: this is reachable from an
        # unauthenticated query route, and an arbitrary [begin, end)
        # would let a remote caller size the loop below at will
        att = self.data_commitment_for_height(height)
        if att is None or att["begin_block"] != begin or (
            att["end_block"] != end
        ):
            raise ValueError(
                f"[{begin}, {end}) is not an attested DataCommitment window"
            )
        leaves = []
        target_root: Optional[bytes] = None
        for h in range(begin, end):
            root = self.data_root(h) or b"\x00" * 32
            if h == height:
                target_root = root
            leaves.append(h.to_bytes(8, "big") + root)
        proof = merkle_proof(leaves, height - begin)
        return {
            "height": height,
            "begin_block": begin,
            "end_block": end,
            "data_root": target_root.hex(),
            "index": proof.index,
            "total": proof.total,
            "aunts": [a.hex() for a in proof.aunts],
            "tuple_root": rfc6962_root_np(leaves).tobytes().hex(),
        }

    def _prune(self, now_ns: int) -> None:
        for _, raw in list(self.store.iterate(_ATTESTATION_PREFIX)):
            att = json.loads(raw)
            if now_ns - att["time_ns"] > ATTESTATION_EXPIRY_NS:
                self.store.delete(
                    _ATTESTATION_PREFIX + att["nonce"].to_bytes(8, "big")
                )
