"""x/blob: PayForBlobs validation, gas metering, params.

Parity with x/blob/: MsgPayForBlobs ValidateBasic
(types/payforblob.go:58-146), GasToConsume (:155-163), ValidateBlobTx
(types/blob_tx.go:37-110, incl. the commitment recompute at :100), keeper
PayForBlobs gas consumption (keeper/keeper.go:42-57), params
GasPerBlobByte=8 / GovMaxSquareSize=64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from celestia_tpu_torch.appconsts import (
    DEFAULT_GAS_PER_BLOB_BYTE,
    DEFAULT_GOV_MAX_SQUARE_SIZE,
    SHARE_SIZE,
    SUPPORTED_SHARE_VERSIONS,
)
from celestia_tpu_torch.da.blob import BlobTx
from celestia_tpu_torch.da.inclusion import create_commitment
from celestia_tpu_torch.da.namespace import Namespace
from celestia_tpu_torch.da.shares import sparse_shares_needed
from celestia_tpu_torch.state.params import ParamsKeeper
from celestia_tpu_torch.state.tx import MsgPayForBlobs, Tx, unmarshal_tx

# Fixed gas overhead of a PFB tx beyond per-byte blob gas
# (x/blob/types/payforblob.go:21-41 envelope: 65k-75k).
PFB_GAS_FIXED_COST = 65_000
FIRST_SPARSE_SHARE_GAS = 1_000  # estimation headroom, not consensus-relevant


def gas_to_consume(blob_sizes, gas_per_blob_byte: int) -> int:
    """shares x 512 x gas_per_blob_byte (payforblob.go:155-163)."""
    total_shares = sum(sparse_shares_needed(s) for s in blob_sizes)
    return total_shares * SHARE_SIZE * gas_per_blob_byte


def estimate_gas(blob_sizes) -> int:
    """Client-side PFB gas estimate (pkg/user Signer.EstimateGas shape)."""
    return gas_to_consume(blob_sizes, DEFAULT_GAS_PER_BLOB_BYTE) + PFB_GAS_FIXED_COST


def validate_msg_pay_for_blobs(msg: MsgPayForBlobs) -> None:
    """MsgPayForBlobs.ValidateBasic parity."""
    n = len(msg.namespaces)
    if n == 0:
        raise ValueError("PFB must reference at least one blob")
    if not (n == len(msg.blob_sizes) == len(msg.share_commitments) == len(msg.share_versions)):
        raise ValueError("PFB field lengths mismatch")
    if len(msg.signer) != 20:
        raise ValueError("invalid signer address")
    for ns_raw, size, comm, ver in zip(
        msg.namespaces, msg.blob_sizes, msg.share_commitments, msg.share_versions
    ):
        Namespace(ns_raw).validate_for_blob()
        if size == 0:
            raise ValueError("blob size must be positive")
        if len(comm) != 32:
            raise ValueError("share commitment must be 32 bytes")
        if ver not in SUPPORTED_SHARE_VERSIONS:
            raise ValueError(f"unsupported share version {ver}")


def validate_blob_tx(blob_tx: BlobTx, chain_id: str) -> Tx:
    """Full BlobTx validation (types/blob_tx.go:37-110): the wrapped tx must
    contain exactly one MsgPayForBlobs whose namespaces, sizes, versions and
    share commitments match the attached blobs (commitments recomputed).

    Returns the decoded inner Tx on success.
    """
    if not blob_tx.blobs:
        raise ValueError("blob tx carries no blobs")
    tx = unmarshal_tx(blob_tx.tx)
    pfbs = [m for m in tx.msgs if isinstance(m, MsgPayForBlobs)]
    if len(pfbs) != 1 or len(tx.msgs) != 1:
        raise ValueError("blob tx must contain exactly one MsgPayForBlobs")
    msg = pfbs[0]
    validate_msg_pay_for_blobs(msg)
    if len(blob_tx.blobs) != len(msg.namespaces):
        raise ValueError("blob count does not match PFB")
    for i, b in enumerate(blob_tx.blobs):
        if b.namespace.raw != msg.namespaces[i]:
            raise ValueError(f"blob {i}: namespace mismatch with PFB")
        if len(b.data) != msg.blob_sizes[i]:
            raise ValueError(f"blob {i}: size mismatch with PFB")
        if b.share_version != msg.share_versions[i]:
            raise ValueError(f"blob {i}: share version mismatch with PFB")
        if create_commitment(b) != msg.share_commitments[i]:
            raise ValueError(f"blob {i}: share commitment mismatch")
    return tx


@dataclass
class BlobKeeper:
    params: ParamsKeeper

    def gas_per_blob_byte(self) -> int:
        return self.params.get("blob", "GasPerBlobByte", DEFAULT_GAS_PER_BLOB_BYTE)

    def gov_max_square_size(self) -> int:
        return self.params.get(
            "blob", "GovMaxSquareSize", DEFAULT_GOV_MAX_SQUARE_SIZE
        )

    def pay_for_blobs(self, msg: MsgPayForBlobs, gas_meter) -> dict:
        """Keeper.PayForBlobs: consume blob gas, emit the event
        (keeper/keeper.go:42-57)."""
        gas = gas_to_consume(msg.blob_sizes, self.gas_per_blob_byte())
        gas_meter.consume(gas, "blob payment")
        return {
            "type": "celestia.blob.v1.EventPayForBlobs",
            "signer": msg.signer.hex(),
            "blob_sizes": list(msg.blob_sizes),
            "namespaces": [ns.hex() for ns in msg.namespaces],
        }
