"""Tx client: thread-safe signer with sequence tracking and recovery.

Parity with pkg/user/signer.go: local-vs-network sequence
tracking (:31-55), SubmitTx / SubmitPayForBlob (:146-169), broadcast with
nonce-mismatch recovery and re-signing (:268-309), ConfirmTx polling
(:365-395), gas estimation (:397-420), and tx options (tx_options.go).

``node`` is any object exposing the node surface (celestia_tpu_torch/node):
  broadcast_tx(raw) -> TxResult-like (code, log, hash)
  get_tx(tx_hash) -> Optional[confirmation dict]
  account_info(address) -> (account_number, sequence)
  simulate(raw) -> gas estimate
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence

from celestia_tpu_torch.client import errors as client_errors
from celestia_tpu_torch.da.blob import Blob, BlobTx
from celestia_tpu_torch.da.inclusion import create_commitment
from celestia_tpu_torch.state.modules.blob import estimate_gas
# SubmitResult moved to state/tx.py (celint R8: the node tier produces
# it); re-exported here so client-side callers are unchanged
from celestia_tpu_torch.state.tx import (  # noqa: F401
    Fee,
    Msg,
    MsgPayForBlobs,
    SubmitResult,
    Tx,
)
from celestia_tpu_torch.utils.secp256k1 import PrivateKey

DEFAULT_GAS_LIMIT = 210_000
DEFAULT_POLL_INTERVAL_S = 0.05
DEFAULT_CONFIRM_TIMEOUT_S = 30.0


class Signer:
    """Thread-safe account signer bound to one node connection."""

    def __init__(
        self,
        node,
        private_key: PrivateKey,
        chain_id: Optional[str] = None,
        gas_price: float = 0.002,
    ):
        self.node = node
        self.key = private_key
        self.pubkey = private_key.public_key()
        self.address = self.pubkey.address()
        self.chain_id = chain_id or node.chain_id
        self.gas_price = gas_price
        # RLock held across the whole sign -> broadcast -> increment window
        # so concurrent submitters never sign with the same sequence
        # (signer.go holds its mutex across broadcastTx the same way)
        self._lock = threading.RLock()
        acct_num, seq = node.account_info(self.address)
        self.account_number = acct_num
        self._sequence = seq

    # --- fees -------------------------------------------------------------

    def _fee(self, gas_limit: int, gas_price: Optional[float] = None) -> Fee:
        price = self.gas_price if gas_price is None else gas_price
        amount = int(gas_limit * price + 0.999999)
        return Fee(amount=amount, gas_limit=gas_limit)

    def estimate_gas(self, msgs: Sequence[Msg]) -> int:
        """Simulate-based estimation (signer.go:397-420)."""
        tx = Tx(
            tuple(msgs), self._fee(DEFAULT_GAS_LIMIT), self.pubkey.compressed(),
            self._sequence, self.account_number,
        )
        return self.node.simulate(tx.marshal())

    # --- submission -------------------------------------------------------

    def sign_tx(
        self,
        msgs: Sequence[Msg],
        gas_limit: int = DEFAULT_GAS_LIMIT,
        gas_price: Optional[float] = None,
        memo: str = "",
        sequence: Optional[int] = None,
        timeout_height: int = 0,
        fee_granter: bytes = b"",
    ) -> Tx:
        with self._lock:
            seq = self._sequence if sequence is None else sequence
            tx = Tx(
                tuple(msgs), self._fee(gas_limit, gas_price),
                self.pubkey.compressed(), seq, self.account_number, memo,
                timeout_height=timeout_height, fee_granter=fee_granter,
            )
            return tx.signed(self.key, self.chain_id)

    def _broadcast(self, make_raw, max_retries: int = 3) -> SubmitResult:
        """Broadcast with nonce-mismatch recovery (signer.go:268-309): on an
        'incorrect account sequence' rejection, adopt the node's expected
        sequence and re-sign.  The lock spans sign+broadcast+increment so a
        concurrent submitter cannot reuse the sequence."""
        with self._lock:
            for _ in range(max_retries):
                raw = make_raw()
                res = self.node.broadcast_tx(raw)
                if res.code == 0:
                    self._sequence += 1
                    return res
                if client_errors.is_nonce_mismatch(res.log):
                    expected = client_errors.parse_expected_sequence(res.log)
                    if expected is not None:
                        self._sequence = expected
                        continue
                return res
            return res

    def submit_tx(self, msgs: Sequence[Msg], **opts) -> SubmitResult:
        """Sign, broadcast, confirm (signer.go SubmitTx)."""
        res = self._broadcast(lambda: self.sign_tx(msgs, **opts).marshal())
        if res.code != 0:
            return res
        return self.confirm_tx(res.tx_hash)

    def submit_pay_for_blob(
        self,
        blobs: Sequence[Blob],
        gas_limit: Optional[int] = None,
        **opts,
    ) -> SubmitResult:
        """SubmitPayForBlob (signer.go:162-169): build MsgPayForBlobs with
        share commitments, wrap the signed tx + blobs in a BlobTx envelope."""
        blobs = list(blobs)
        msg = MsgPayForBlobs(
            signer=self.address,
            namespaces=tuple(b.namespace.raw for b in blobs),
            blob_sizes=tuple(len(b.data) for b in blobs),
            share_commitments=tuple(create_commitment(b) for b in blobs),
            share_versions=tuple(b.share_version for b in blobs),
        )
        if gas_limit is None:
            gas_limit = estimate_gas([len(b.data) for b in blobs])

        def make_raw() -> bytes:
            tx = self.sign_tx([msg], gas_limit=gas_limit, **opts)
            return BlobTx(tx=tx.marshal(), blobs=tuple(blobs)).marshal()

        res = self._broadcast(make_raw)
        if res.code != 0:
            return res
        return self.confirm_tx(res.tx_hash)

    # --- confirmation -----------------------------------------------------

    def confirm_tx(
        self,
        tx_hash: bytes,
        timeout_s: float = DEFAULT_CONFIRM_TIMEOUT_S,
        poll_interval_s: float = DEFAULT_POLL_INTERVAL_S,
    ) -> SubmitResult:
        """Poll until the tx lands in a block (signer.go:365-395), on the
        unified RetryPolicy (utils/faults.py): jittered poll intervals,
        hard deadline budget, reproducible under a chaos seed."""
        from celestia_tpu_torch.utils.faults import RetryPolicy

        info = RetryPolicy(
            base_s=poll_interval_s,
            cap_s=max(poll_interval_s * 2, 0.25),
            deadline_s=timeout_s,
        ).poll(
            lambda: self.node.get_tx(tx_hash),
            what=f"tx {tx_hash.hex()} confirmation",
        )
        return SubmitResult(
            code=info["code"], log=info.get("log", ""),
            tx_hash=tx_hash, height=info["height"],
        )

    @property
    def sequence(self) -> int:
        with self._lock:
            return self._sequence
