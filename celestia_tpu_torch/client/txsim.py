"""txsim: composable transaction load generator.

Parity with test/txsim/: the Sequence interface
(sequence.go:16-31) with cloneable blob/send/stake sequences (blob.go:23,
send.go:23, stake.go:19) and the run loop (run.go:31-115) that drives N
sequences against a node, each with its own funded signer.

Copied from ``celestia_tpu/client/txsim.py`` without ``run_remote``: the
remote node client (``node/remote.py``) is not part of the port yet.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence as TypingSequence

import numpy as np

from celestia_tpu_torch.client.signer import Signer
from celestia_tpu_torch.da.blob import Blob
from celestia_tpu_torch.da.namespace import Namespace
from celestia_tpu_torch.state.tx import MsgDelegate, MsgSend
from celestia_tpu_torch.utils.secp256k1 import PrivateKey


class Sequence:
    """One repeating workload (sequence.go Sequence interface)."""

    def clone(self, n: int) -> List["Sequence"]:
        import copy

        return [copy.deepcopy(self) for _ in range(n)]

    def init(self, signer: Signer, rng: np.random.Generator) -> None:
        self.signer = signer
        self.rng = rng

    def next(self) -> Optional[dict]:
        """Submit one tx; return a result record (None = sequence done)."""
        raise NotImplementedError


@dataclass
class BlobSequence(Sequence):
    """Random blobs within size/count bounds (txsim/blob.go)."""

    size_min: int = 100
    size_max: int = 10_000
    blobs_per_tx: int = 1
    namespace_seed: bytes = b"txsim"

    def next(self) -> Optional[dict]:
        blobs = []
        for i in range(self.blobs_per_tx):
            size = int(self.rng.integers(self.size_min, self.size_max + 1))
            ns = Namespace.v0(
                hashlib.sha256(self.namespace_seed + bytes([i])).digest()[:10]
            )
            data = self.rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            blobs.append(Blob(ns, data))
        res = self.signer.submit_pay_for_blob(blobs)
        return {"type": "blob", "code": res.code, "log": res.log, "height": res.height}


@dataclass
class SendSequence(Sequence):
    """Token transfers to a rotating set of destinations (txsim/send.go)."""

    amount: int = 100

    def next(self) -> Optional[dict]:
        dest = hashlib.sha256(self.rng.bytes(8)).digest()[:20]
        res = self.signer.submit_tx([MsgSend(self.signer.address, dest, self.amount)])
        return {"type": "send", "code": res.code, "log": res.log, "height": res.height}


@dataclass
class StakeSequence(Sequence):
    """Delegations to the validator set (txsim/stake.go)."""

    amount: int = 1_000_000

    def next(self) -> Optional[dict]:
        # transport-agnostic: the validators query route works both
        # in-process and over gRPC (RemoteNode.abci_query)
        validators = self.signer.node.abci_query("custom/staking/validators", {})
        if not validators:
            return None
        val = validators[int(self.rng.integers(len(validators)))]
        res = self.signer.submit_tx(
            [MsgDelegate(self.signer.address, bytes.fromhex(val["operator"]), self.amount)]
        )
        return {"type": "stake", "code": res.code, "log": res.log, "height": res.height}


def _drive(
    sequences: TypingSequence[Sequence],
    signers: List[Signer],
    iterations: int,
    seed: int,
) -> List[dict]:
    """The round-robin drive loop of run (run.go:31-115;
    the reference runs each sequence in a goroutine — here rounds
    interleave deterministically, which exercises the same mempool /
    sequence contention paths reproducibly)."""
    results: List[dict] = []
    for i, seq in enumerate(sequences):
        seq.init(signers[i], np.random.default_rng(seed * 1000 + i))
    active = list(sequences)
    for _ in range(iterations):
        still_active = []
        for seq in active:
            rec = seq.next()
            if rec is None:  # sequence finished: stop polling it
                continue
            results.append(rec)
            still_active.append(seq)
        active = still_active
        if not active:
            break
    return results


def run(
    node,
    sequences: TypingSequence[Sequence],
    iterations: int = 10,
    seed: int = 0,
    funding: int = 10**12,
) -> List[dict]:
    """txsim against an in-process node: sub-accounts are funded straight
    from the faucet (minted), then sequences run round-robin."""
    signers = []
    for i in range(len(sequences)):
        key = PrivateKey.from_seed(b"txsim-%d" % i + seed.to_bytes(4, "big"))
        addr = key.public_key().address()
        node.app.bank.mint(addr, funding)
        node.app.accounts.get_or_create(addr)
        signers.append(Signer(node, key))
    return _drive(sequences, signers, iterations, seed)
