"""Client-side Blobstream verification.

Parity with x/blobstream/client/verify.go:197,323
(VerifyShares / VerifyDataRootInclusion): prove that shares committed at
some height are covered by a Blobstream DataCommitment attestation — the
artifact an EVM rollup bridge consumes — walking three links, each
verified CLIENT-SIDE against nothing but the attestation root:

1. share inclusion -> the block's data root (NMT range proof + row-root
   merkle proof, da/proof.ShareInclusionProof);
2. the height's DataCommitment window (queried from the node);
3. the (height, data_root) tuple's merkle inclusion in the window's
   data_root_tuple_root (RFC-6962 proof, da/proof.MerkleProof).

Trust model (stated precisely): the DataCommitment attestation — and
with it the data_root_tuple_root — is the TRUST ANCHOR and is taken as
served.  In the reference deployment that root lives in the Blobstream
EVM contract, placed there under the bridge valset's signatures; here
the node's attested root plays that role (anchor it independently —
e.g. prove the attestation record against a BFT-certified app hash via
store/proof — when the serving node itself is untrusted).  Everything
BELOW the anchor is verified client-side: a tampered share, share
proof, data root, window claim, or tuple proof fails the corresponding
check no matter what the node serves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from celestia_tpu_torch.da.proof import MerkleProof, ShareInclusionProof


class BlobstreamVerifyError(ValueError):
    pass


def verify_data_root_inclusion(
    height: int, data_root: bytes, proof: dict, tuple_root: bytes
) -> bool:
    """VerifyDataRootInclusion parity (client/verify.go:323): check the
    (height, data_root) tuple leaf against the attested tuple root."""
    leaf = height.to_bytes(8, "big") + data_root
    mp = MerkleProof(
        index=int(proof["index"]),
        total=int(proof["total"]),
        aunts=tuple(bytes.fromhex(a) for a in proof["aunts"]),
    )
    return mp.verify(tuple_root, leaf)


@dataclass(frozen=True)
class VerifiedShares:
    height: int
    data_root: bytes
    nonce: int
    begin_block: int
    end_block: int
    tuple_root: bytes


def verify_shares(
    node, height: int, start: int, end: int
) -> VerifiedShares:
    """VerifyShares parity (client/verify.go:197): prove shares
    [start, end) at ``height`` are committed to by a Blobstream
    DataCommitment.  ``node`` is anything with the abci_query surface
    (RemoteNode or TestNode).  Raises BlobstreamVerifyError on any
    broken link; returns the verified chain's facts on success."""
    # 1. share -> data root
    bundle = node.abci_query(
        "custom/proof/share", {"height": height, "start": start, "end": end}
    )
    proof = ShareInclusionProof.from_dict(bundle["proof"])
    data_root = bytes.fromhex(bundle["data_root"])
    if not proof.verify(data_root):
        raise BlobstreamVerifyError(
            "share inclusion proof does not verify against the data root"
        )
    # 2. which DataCommitment window covers this height?
    rng = node.abci_query(
        "custom/blobstream/data_commitment_range", {"height": height}
    )
    if not rng.get("found"):
        raise BlobstreamVerifyError(
            f"no DataCommitment attestation covers height {height} "
            "(window not yet closed?)"
        )
    att = rng["data_commitment"]
    tuple_root = bytes.fromhex(att["data_root_tuple_root"])
    # 3. (height, data_root) -> the attested tuple root
    dri = node.abci_query(
        "custom/blobstream/data_root_inclusion",
        {
            "height": height,
            "begin": att["begin_block"],
            "end": att["end_block"],
        },
    )
    served_root = bytes.fromhex(dri["data_root"])
    if served_root != data_root:
        raise BlobstreamVerifyError(
            "node served a different data root for the tuple proof than "
            "the share proof was verified against"
        )
    if not verify_data_root_inclusion(height, data_root, dri, tuple_root):
        raise BlobstreamVerifyError(
            "data root tuple proof does not verify against the attested "
            "DataCommitment root"
        )
    return VerifiedShares(
        height=height,
        data_root=data_root,
        nonce=int(att["nonce"]),
        begin_block=int(att["begin_block"]),
        end_block=int(att["end_block"]),
        tuple_root=tuple_root,
    )
