"""Transaction codec: messages, fees, sign bytes, signatures.

This framework's equivalent of the reference's SDK tx layer
(app/encoding/encoding.go MakeConfig + SIGN_MODE_DIRECT signing used by
pkg/user/signer.go:507-562).  Wire format is a deterministic length-prefixed
binary encoding (not protobuf — one canonical byte representation, no
map/ordering pitfalls); sign bytes cover body + auth info + chain id, so
fee, gas, sequence and chain are all signature-protected.

Message set mirrors the reference's state-machine surface (SURVEY.md §2.1):
bank send, x/blob MsgPayForBlobs, x/upgrade signal/try-upgrade, x/blobstream
EVM-address registration, staking delegate/undelegate, and a gov-gated param
change (x/paramfilter's enforcement point).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

from celestia_tpu_torch.da.namespace import Namespace
from celestia_tpu_torch.da.shares import _read_varint, _varint
from celestia_tpu_torch.utils.secp256k1 import (
    MULTISIG_PREFIX,
    MultisigPubKey,
    PrivateKey,
    PublicKey,
)

ADDRESS_SIZE = 20


def _put_bytes(out: bytearray, b: bytes):
    out += _varint(len(b))
    out += b


def _get_bytes(raw: bytes, pos: int) -> Tuple[bytes, int]:
    n, pos = _read_varint(raw, pos)
    if pos + n > len(raw):
        raise ValueError("truncated bytes field")
    return raw[pos : pos + n], pos + n


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------


@dataclass
class SubmitResult:
    """Outcome of a tx broadcast (the BroadcastTx RPC surface).  Lives
    here — not in client/signer.py where it grew up — because the node
    tier PRODUCES it (testnode broadcast, network replication) and the
    client tier consumes it: state/ is the layer both may import
    (celint R8)."""

    code: int
    log: str
    tx_hash: bytes
    height: Optional[int] = None


@dataclass(frozen=True)
class MsgSend:
    """x/bank transfer (the reference's most common non-blob tx)."""

    from_addr: bytes
    to_addr: bytes
    amount: int  # utia

    TYPE = 1

    def signers(self) -> List[bytes]:
        return [self.from_addr]


@dataclass(frozen=True)
class MsgPayForBlobs:
    """x/blob MsgPayForBlobs (x/blob/types/payforblob.go:49-146 parity):
    pays for blob inclusion; blobs themselves never touch state."""

    signer: bytes
    namespaces: Tuple[bytes, ...]  # 29-byte raw namespaces
    blob_sizes: Tuple[int, ...]
    share_commitments: Tuple[bytes, ...]  # 32-byte commitments
    share_versions: Tuple[int, ...]

    TYPE = 2

    def signers(self) -> List[bytes]:
        return [self.signer]


@dataclass(frozen=True)
class MsgSignalVersion:
    """x/upgrade: validator signals readiness for an app version."""

    validator: bytes
    version: int

    TYPE = 3

    def signers(self) -> List[bytes]:
        return [self.validator]


@dataclass(frozen=True)
class MsgTryUpgrade:
    """x/upgrade: tally signals; upgrade if >= 5/6 of power signalled."""

    signer: bytes

    TYPE = 4

    def signers(self) -> List[bytes]:
        return [self.signer]


@dataclass(frozen=True)
class MsgRegisterEVMAddress:
    """x/blobstream: validator registers its EVM orchestrator address."""

    validator: bytes
    evm_address: bytes  # 20 bytes

    TYPE = 5

    def signers(self) -> List[bytes]:
        return [self.validator]


@dataclass(frozen=True)
class MsgDelegate:
    delegator: bytes
    validator: bytes
    amount: int

    TYPE = 6

    def signers(self) -> List[bytes]:
        return [self.delegator]


@dataclass(frozen=True)
class MsgUndelegate:
    delegator: bytes
    validator: bytes
    amount: int

    TYPE = 7

    def signers(self) -> List[bytes]:
        return [self.delegator]


@dataclass(frozen=True)
class MsgParamChange:
    """Governance parameter change.  The executing authority MUST be the gov
    module account (GOV_MODULE_ADDR) — params are only writable through a
    passed proposal, never by a user-signed message
    (x/paramfilter/gov_handler.go:36-60: the reference exposes param changes
    exclusively through the gov proposal route).  x/paramfilter additionally
    blocks hardfork-only params."""

    authority: bytes
    subspace: str
    key: str
    value: bytes

    TYPE = 8

    def signers(self) -> List[bytes]:
        return [self.authority]


@dataclass(frozen=True)
class MsgSubmitProposal:
    """Submit a governance proposal: param changes (ParamChangeProposal,
    executed through the blocklist-gated handler,
    x/paramfilter/gov_handler.go:36-60) and/or a community-pool spend
    (distribution CommunityPoolSpendProposal)."""

    proposer: bytes
    title: str
    description: str
    # each change: (subspace, key, json-encoded value)
    changes: Tuple[Tuple[str, str, bytes], ...]
    deposit: int
    # community-pool spend (0 amount = none)
    spend_to: bytes = b""
    spend_amount: int = 0

    TYPE = 9

    def signers(self) -> List[bytes]:
        return [self.proposer]


@dataclass(frozen=True)
class MsgVote:
    """Vote on an active governance proposal (x/gov vote)."""

    voter: bytes
    proposal_id: int
    option: int  # 1 = yes, 2 = no, 3 = abstain, 4 = no-with-veto

    TYPE = 10

    OPTION_YES = 1
    OPTION_NO = 2
    OPTION_ABSTAIN = 3
    OPTION_VETO = 4

    def signers(self) -> List[bytes]:
        return [self.voter]


@dataclass(frozen=True)
class MsgGrantAllowance:
    """x/feegrant: grant a fee allowance (basic or periodic)."""

    granter: bytes
    grantee: bytes
    kind: int  # feegrant.KIND_BASIC / KIND_PERIODIC
    spend_limit: int  # 0 = unlimited
    expiration_ns: int  # 0 = never
    period_ns: int = 0
    period_spend_limit: int = 0

    TYPE = 11

    def signers(self) -> List[bytes]:
        return [self.granter]


@dataclass(frozen=True)
class MsgRevokeAllowance:
    """x/feegrant: revoke a fee allowance."""

    granter: bytes
    grantee: bytes

    TYPE = 12

    def signers(self) -> List[bytes]:
        return [self.granter]


@dataclass(frozen=True)
class MsgAuthzGrant:
    """x/authz: authorize a grantee to execute a message type."""

    granter: bytes
    grantee: bytes
    msg_type: int  # Msg.TYPE id of the authorized message
    spend_limit: int  # 0 = unlimited (generic authorization)
    expiration_ns: int  # 0 = never

    TYPE = 13

    def signers(self) -> List[bytes]:
        return [self.granter]


@dataclass(frozen=True)
class MsgAuthzRevoke:
    """x/authz: revoke an authorization."""

    granter: bytes
    grantee: bytes
    msg_type: int

    TYPE = 14

    def signers(self) -> List[bytes]:
        return [self.granter]


@dataclass(frozen=True)
class MsgExec:
    """x/authz: execute wrapped messages under existing grants.  The tx is
    signed by the grantee; each inner message's declared signer must have
    granted the matching authorization."""

    grantee: bytes
    inner: Tuple["Msg", ...]

    TYPE = 15

    def signers(self) -> List[bytes]:
        return [self.grantee]


@dataclass(frozen=True)
class MsgWithdrawDelegatorReward:
    """x/distribution: withdraw accrued delegation rewards."""

    delegator: bytes
    validator: bytes

    TYPE = 16

    def signers(self) -> List[bytes]:
        return [self.delegator]


@dataclass(frozen=True)
class MsgWithdrawValidatorCommission:
    """x/distribution: withdraw a validator's accrued commission."""

    validator: bytes

    TYPE = 17

    def signers(self) -> List[bytes]:
        return [self.validator]


@dataclass(frozen=True)
class MsgFundCommunityPool:
    """x/distribution: move own funds into the community pool."""

    depositor: bytes
    amount: int

    TYPE = 18

    def signers(self) -> List[bytes]:
        return [self.depositor]


@dataclass(frozen=True)
class MsgSetWithdrawAddress:
    """x/distribution: set the address rewards are withdrawn to."""

    delegator: bytes
    withdraw_address: bytes

    TYPE = 19

    def signers(self) -> List[bytes]:
        return [self.delegator]


@dataclass(frozen=True)
class MsgUnjail:
    """x/slashing: a jailed validator rejoins after its jail duration."""

    validator: bytes

    TYPE = 20

    def signers(self) -> List[bytes]:
        return [self.validator]


@dataclass(frozen=True)
class MsgSubmitEvidence:
    """x/evidence: submit equivocation (double-sign) evidence.  Carries the
    two conflicting signed votes — the evidence must prove itself (the
    msg path is open to anyone, unlike comet's pre-verified stream)."""

    submitter: bytes
    validator: bytes
    height: int
    time_ns: int
    block_hash_a: bytes = b""
    sig_a: bytes = b""
    block_hash_b: bytes = b""
    sig_b: bytes = b""

    TYPE = 21

    def signers(self) -> List[bytes]:
        return [self.submitter]


@dataclass(frozen=True)
class MsgVerifyInvariant:
    """x/crisis: force an on-chain invariant check (empty route = all)."""

    sender: bytes
    invariant: str = ""

    TYPE = 22

    def signers(self) -> List[bytes]:
        return [self.sender]


@dataclass(frozen=True)
class MsgCreateVestingAccount:
    """auth/vesting: fund a new account under a vesting schedule
    (continuous by default; delayed locks everything until end_time)."""

    from_addr: bytes
    to_addr: bytes
    amount: int
    end_time_ns: int
    delayed: bool = False

    TYPE = 23

    def signers(self) -> List[bytes]:
        return [self.from_addr]


Msg = Union[
    MsgSend,
    MsgPayForBlobs,
    MsgSignalVersion,
    MsgTryUpgrade,
    MsgRegisterEVMAddress,
    MsgDelegate,
    MsgUndelegate,
    MsgParamChange,
    MsgSubmitProposal,
    MsgVote,
    MsgGrantAllowance,
    MsgRevokeAllowance,
    MsgAuthzGrant,
    MsgAuthzRevoke,
    MsgExec,
    MsgWithdrawDelegatorReward,
    MsgWithdrawValidatorCommission,
    MsgFundCommunityPool,
    MsgSetWithdrawAddress,
    MsgUnjail,
    MsgSubmitEvidence,
    MsgVerifyInvariant,
    MsgCreateVestingAccount,
]

_MSG_TYPES = {
    cls.TYPE: cls
    for cls in (
        MsgSend,
        MsgPayForBlobs,
        MsgSignalVersion,
        MsgTryUpgrade,
        MsgRegisterEVMAddress,
        MsgDelegate,
        MsgUndelegate,
        MsgParamChange,
        MsgSubmitProposal,
        MsgVote,
        MsgGrantAllowance,
        MsgRevokeAllowance,
        MsgAuthzGrant,
        MsgAuthzRevoke,
        MsgExec,
        MsgWithdrawDelegatorReward,
        MsgWithdrawValidatorCommission,
        MsgFundCommunityPool,
        MsgSetWithdrawAddress,
        MsgUnjail,
        MsgSubmitEvidence,
        MsgVerifyInvariant,
        MsgCreateVestingAccount,
    )
}


def marshal_msg(msg: Msg) -> bytes:
    out = bytearray()
    out += _varint(msg.TYPE)
    if isinstance(msg, MsgSend):
        _put_bytes(out, msg.from_addr)
        _put_bytes(out, msg.to_addr)
        out += _varint(msg.amount)
    elif isinstance(msg, MsgPayForBlobs):
        _put_bytes(out, msg.signer)
        out += _varint(len(msg.namespaces))
        for ns, size, comm, ver in zip(
            msg.namespaces, msg.blob_sizes, msg.share_commitments, msg.share_versions
        ):
            _put_bytes(out, ns)
            out += _varint(size)
            _put_bytes(out, comm)
            out += _varint(ver)
    elif isinstance(msg, MsgSignalVersion):
        _put_bytes(out, msg.validator)
        out += _varint(msg.version)
    elif isinstance(msg, MsgTryUpgrade):
        _put_bytes(out, msg.signer)
    elif isinstance(msg, MsgRegisterEVMAddress):
        _put_bytes(out, msg.validator)
        _put_bytes(out, msg.evm_address)
    elif isinstance(msg, (MsgDelegate, MsgUndelegate)):
        _put_bytes(out, msg.delegator)
        _put_bytes(out, msg.validator)
        out += _varint(msg.amount)
    elif isinstance(msg, MsgParamChange):
        _put_bytes(out, msg.authority)
        _put_bytes(out, msg.subspace.encode())
        _put_bytes(out, msg.key.encode())
        _put_bytes(out, msg.value)
    elif isinstance(msg, MsgSubmitProposal):
        _put_bytes(out, msg.proposer)
        _put_bytes(out, msg.title.encode())
        _put_bytes(out, msg.description.encode())
        out += _varint(len(msg.changes))
        for sub, key, val in msg.changes:
            _put_bytes(out, sub.encode())
            _put_bytes(out, key.encode())
            _put_bytes(out, val)
        out += _varint(msg.deposit)
        _put_bytes(out, msg.spend_to)
        out += _varint(msg.spend_amount)
    elif isinstance(msg, MsgVote):
        _put_bytes(out, msg.voter)
        out += _varint(msg.proposal_id)
        out += _varint(msg.option)
    elif isinstance(msg, MsgGrantAllowance):
        _put_bytes(out, msg.granter)
        _put_bytes(out, msg.grantee)
        out += _varint(msg.kind)
        out += _varint(msg.spend_limit)
        out += _varint(msg.expiration_ns)
        out += _varint(msg.period_ns)
        out += _varint(msg.period_spend_limit)
    elif isinstance(msg, MsgRevokeAllowance):
        _put_bytes(out, msg.granter)
        _put_bytes(out, msg.grantee)
    elif isinstance(msg, MsgAuthzGrant):
        _put_bytes(out, msg.granter)
        _put_bytes(out, msg.grantee)
        out += _varint(msg.msg_type)
        out += _varint(msg.spend_limit)
        out += _varint(msg.expiration_ns)
    elif isinstance(msg, MsgAuthzRevoke):
        _put_bytes(out, msg.granter)
        _put_bytes(out, msg.grantee)
        out += _varint(msg.msg_type)
    elif isinstance(msg, MsgExec):
        _put_bytes(out, msg.grantee)
        out += _varint(len(msg.inner))
        for im in msg.inner:
            _put_bytes(out, marshal_msg(im))
    elif isinstance(msg, MsgWithdrawDelegatorReward):
        _put_bytes(out, msg.delegator)
        _put_bytes(out, msg.validator)
    elif isinstance(msg, MsgWithdrawValidatorCommission):
        _put_bytes(out, msg.validator)
    elif isinstance(msg, MsgFundCommunityPool):
        _put_bytes(out, msg.depositor)
        out += _varint(msg.amount)
    elif isinstance(msg, MsgSetWithdrawAddress):
        _put_bytes(out, msg.delegator)
        _put_bytes(out, msg.withdraw_address)
    elif isinstance(msg, MsgUnjail):
        _put_bytes(out, msg.validator)
    elif isinstance(msg, MsgSubmitEvidence):
        _put_bytes(out, msg.submitter)
        _put_bytes(out, msg.validator)
        out += _varint(msg.height)
        out += _varint(msg.time_ns)
        _put_bytes(out, msg.block_hash_a)
        _put_bytes(out, msg.sig_a)
        _put_bytes(out, msg.block_hash_b)
        _put_bytes(out, msg.sig_b)
    elif isinstance(msg, MsgVerifyInvariant):
        _put_bytes(out, msg.sender)
        _put_bytes(out, msg.invariant.encode())
    elif isinstance(msg, MsgCreateVestingAccount):
        _put_bytes(out, msg.from_addr)
        _put_bytes(out, msg.to_addr)
        out += _varint(msg.amount)
        out += _varint(msg.end_time_ns)
        out += _varint(1 if msg.delayed else 0)
    else:
        raise TypeError(f"unknown msg type {type(msg)}")
    return bytes(out)


def unmarshal_msg(raw: bytes, pos: int = 0) -> Tuple[Msg, int]:
    t, pos = _read_varint(raw, pos)
    if t == MsgSend.TYPE:
        frm, pos = _get_bytes(raw, pos)
        to, pos = _get_bytes(raw, pos)
        amt, pos = _read_varint(raw, pos)
        return MsgSend(frm, to, amt), pos
    if t == MsgPayForBlobs.TYPE:
        signer, pos = _get_bytes(raw, pos)
        n, pos = _read_varint(raw, pos)
        nss, sizes, comms, vers = [], [], [], []
        for _ in range(n):
            ns, pos = _get_bytes(raw, pos)
            size, pos = _read_varint(raw, pos)
            comm, pos = _get_bytes(raw, pos)
            ver, pos = _read_varint(raw, pos)
            nss.append(ns)
            sizes.append(size)
            comms.append(comm)
            vers.append(ver)
        return (
            MsgPayForBlobs(
                signer, tuple(nss), tuple(sizes), tuple(comms), tuple(vers)
            ),
            pos,
        )
    if t == MsgSignalVersion.TYPE:
        val, pos = _get_bytes(raw, pos)
        ver, pos = _read_varint(raw, pos)
        return MsgSignalVersion(val, ver), pos
    if t == MsgTryUpgrade.TYPE:
        signer, pos = _get_bytes(raw, pos)
        return MsgTryUpgrade(signer), pos
    if t == MsgRegisterEVMAddress.TYPE:
        val, pos = _get_bytes(raw, pos)
        evm, pos = _get_bytes(raw, pos)
        return MsgRegisterEVMAddress(val, evm), pos
    if t in (MsgDelegate.TYPE, MsgUndelegate.TYPE):
        d, pos = _get_bytes(raw, pos)
        v, pos = _get_bytes(raw, pos)
        amt, pos = _read_varint(raw, pos)
        cls = MsgDelegate if t == MsgDelegate.TYPE else MsgUndelegate
        return cls(d, v, amt), pos
    if t == MsgParamChange.TYPE:
        auth, pos = _get_bytes(raw, pos)
        sub, pos = _get_bytes(raw, pos)
        key, pos = _get_bytes(raw, pos)
        val, pos = _get_bytes(raw, pos)
        return MsgParamChange(auth, sub.decode(), key.decode(), val), pos
    if t == MsgSubmitProposal.TYPE:
        proposer, pos = _get_bytes(raw, pos)
        title, pos = _get_bytes(raw, pos)
        desc, pos = _get_bytes(raw, pos)
        n, pos = _read_varint(raw, pos)
        changes = []
        for _ in range(n):
            sub, pos = _get_bytes(raw, pos)
            key, pos = _get_bytes(raw, pos)
            val, pos = _get_bytes(raw, pos)
            changes.append((sub.decode(), key.decode(), val))
        deposit, pos = _read_varint(raw, pos)
        spend_to, pos = _get_bytes(raw, pos)
        spend_amount, pos = _read_varint(raw, pos)
        return (
            MsgSubmitProposal(
                proposer, title.decode(), desc.decode(), tuple(changes),
                deposit, spend_to, spend_amount,
            ),
            pos,
        )
    if t == MsgVote.TYPE:
        voter, pos = _get_bytes(raw, pos)
        pid, pos = _read_varint(raw, pos)
        opt, pos = _read_varint(raw, pos)
        return MsgVote(voter, pid, opt), pos
    if t == MsgGrantAllowance.TYPE:
        granter, pos = _get_bytes(raw, pos)
        grantee, pos = _get_bytes(raw, pos)
        kind, pos = _read_varint(raw, pos)
        spend, pos = _read_varint(raw, pos)
        exp, pos = _read_varint(raw, pos)
        pns, pos = _read_varint(raw, pos)
        plim, pos = _read_varint(raw, pos)
        return MsgGrantAllowance(granter, grantee, kind, spend, exp, pns, plim), pos
    if t == MsgRevokeAllowance.TYPE:
        granter, pos = _get_bytes(raw, pos)
        grantee, pos = _get_bytes(raw, pos)
        return MsgRevokeAllowance(granter, grantee), pos
    if t == MsgAuthzGrant.TYPE:
        granter, pos = _get_bytes(raw, pos)
        grantee, pos = _get_bytes(raw, pos)
        mt, pos = _read_varint(raw, pos)
        spend, pos = _read_varint(raw, pos)
        exp, pos = _read_varint(raw, pos)
        return MsgAuthzGrant(granter, grantee, mt, spend, exp), pos
    if t == MsgAuthzRevoke.TYPE:
        granter, pos = _get_bytes(raw, pos)
        grantee, pos = _get_bytes(raw, pos)
        mt, pos = _read_varint(raw, pos)
        return MsgAuthzRevoke(granter, grantee, mt), pos
    if t == MsgExec.TYPE:
        grantee, pos = _get_bytes(raw, pos)
        n, pos = _read_varint(raw, pos)
        if n > 32:
            raise ValueError("MsgExec carries too many inner messages")
        inner = []
        for _ in range(n):
            imraw, pos = _get_bytes(raw, pos)
            im, used = unmarshal_msg(imraw)
            if used != len(imraw):
                raise ValueError("trailing bytes in MsgExec inner msg")
            if isinstance(im, MsgExec):
                raise ValueError("nested MsgExec is not allowed")
            inner.append(im)
        return MsgExec(grantee, tuple(inner)), pos
    if t == MsgWithdrawDelegatorReward.TYPE:
        d, pos = _get_bytes(raw, pos)
        v, pos = _get_bytes(raw, pos)
        return MsgWithdrawDelegatorReward(d, v), pos
    if t == MsgWithdrawValidatorCommission.TYPE:
        v, pos = _get_bytes(raw, pos)
        return MsgWithdrawValidatorCommission(v), pos
    if t == MsgFundCommunityPool.TYPE:
        d, pos = _get_bytes(raw, pos)
        amt, pos = _read_varint(raw, pos)
        return MsgFundCommunityPool(d, amt), pos
    if t == MsgSetWithdrawAddress.TYPE:
        d, pos = _get_bytes(raw, pos)
        wa, pos = _get_bytes(raw, pos)
        return MsgSetWithdrawAddress(d, wa), pos
    if t == MsgUnjail.TYPE:
        v, pos = _get_bytes(raw, pos)
        return MsgUnjail(v), pos
    if t == MsgSubmitEvidence.TYPE:
        s, pos = _get_bytes(raw, pos)
        v, pos = _get_bytes(raw, pos)
        h, pos = _read_varint(raw, pos)
        tns, pos = _read_varint(raw, pos)
        bha, pos = _get_bytes(raw, pos)
        siga, pos = _get_bytes(raw, pos)
        bhb, pos = _get_bytes(raw, pos)
        sigb, pos = _get_bytes(raw, pos)
        return MsgSubmitEvidence(s, v, h, tns, bha, siga, bhb, sigb), pos
    if t == MsgVerifyInvariant.TYPE:
        s, pos = _get_bytes(raw, pos)
        inv, pos = _get_bytes(raw, pos)
        return MsgVerifyInvariant(s, inv.decode()), pos
    if t == MsgCreateVestingAccount.TYPE:
        f, pos = _get_bytes(raw, pos)
        to, pos = _get_bytes(raw, pos)
        amt, pos = _read_varint(raw, pos)
        end, pos = _read_varint(raw, pos)
        delayed, pos = _read_varint(raw, pos)
        return MsgCreateVestingAccount(f, to, amt, end, bool(delayed)), pos
    raise ValueError(f"unknown msg type id {t}")


# ---------------------------------------------------------------------------
# Tx
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Fee:
    amount: int  # utia
    gas_limit: int

    def gas_price(self) -> float:
        return self.amount / self.gas_limit if self.gas_limit else 0.0


@dataclass(frozen=True)
class Tx:
    msgs: Tuple[Msg, ...]
    fee: Fee
    pubkey: bytes  # 33-byte compressed secp256k1
    sequence: int
    account_number: int
    memo: str = ""
    signature: bytes = b""
    # reject inclusion above this height; 0 = no timeout (the SDK's
    # TxTimeoutHeightDecorator field)
    timeout_height: int = 0
    # x/feegrant: when set, this address's allowance pays the fee instead
    # of the signer (SDK Fee.granter; covered by the signature)
    fee_granter: bytes = b""

    def body_bytes(self) -> bytes:
        out = bytearray()
        out += _varint(len(self.msgs))
        for m in self.msgs:
            _put_bytes(out, marshal_msg(m))
        _put_bytes(out, self.memo.encode())
        out += _varint(self.timeout_height)
        return bytes(out)

    def auth_bytes(self) -> bytes:
        out = bytearray()
        out += _varint(self.fee.amount)
        out += _varint(self.fee.gas_limit)
        _put_bytes(out, self.pubkey)
        out += _varint(self.sequence)
        out += _varint(self.account_number)
        _put_bytes(out, self.fee_granter)
        return bytes(out)

    def sign_bytes(self, chain_id: str) -> bytes:
        # memoized: decoded Tx objects are cached across CheckTx/Prepare/
        # Process (state/app.py _decoded_cache), and each stage re-derives
        # the same digest; the object is immutable so the digest is too
        cached = getattr(self, "_sign_bytes_memo", None)
        if cached is not None and cached[0] == chain_id:
            return cached[1]
        out = bytearray()
        _put_bytes(out, chain_id.encode())
        # decoded txs carry their verbatim wire slices (unmarshal_tx);
        # locally-built txs serialize fresh — identical bytes either way
        # because the wire is canonical (minimal varints enforced by
        # _read_varint), and the raw slices are what the signature
        # actually covers (SignDoc parity)
        body = getattr(self, "_wire_body", None)
        auth = getattr(self, "_wire_auth", None)
        _put_bytes(out, body if body is not None else self.body_bytes())
        _put_bytes(out, auth if auth is not None else self.auth_bytes())
        digest = hashlib.sha256(bytes(out)).digest()
        object.__setattr__(self, "_sign_bytes_memo", (chain_id, digest))
        return digest

    def signed(self, priv: PrivateKey, chain_id: str) -> "Tx":
        sig = priv.sign(self.sign_bytes(chain_id))
        return Tx(
            self.msgs, self.fee, self.pubkey, self.sequence,
            self.account_number, self.memo, sig, self.timeout_height,
            self.fee_granter,
        )

    def is_multisig(self) -> bool:
        return bool(self.pubkey) and self.pubkey[0] == MULTISIG_PREFIX

    def verify_signature(self, chain_id: str) -> bool:
        msg = self.sign_bytes(chain_id)
        if self.is_multisig():
            try:
                mk = MultisigPubKey.unmarshal(self.pubkey)
            except ValueError:
                return False
            return mk.verify(msg, self.signature)
        try:
            pk = PublicKey.from_compressed(self.pubkey)
        except ValueError:
            return False
        return pk.verify(msg, self.signature)

    def signer_address(self) -> bytes:
        # memoized: the ante chain derives the signer several times per
        # tx and decoded txs are cached across admission/filter passes
        # (idempotent, so benign under concurrent first calls)
        memo = self.__dict__.get("_signer_addr")
        if memo is None:
            if self.is_multisig():
                memo = MultisigPubKey.unmarshal(self.pubkey).address()
            else:
                memo = PublicKey.from_compressed(self.pubkey).address()
            object.__setattr__(self, "_signer_addr", memo)
        return memo

    def marshal(self) -> bytes:
        out = bytearray()
        _put_bytes(out, self.body_bytes())
        _put_bytes(out, self.auth_bytes())
        _put_bytes(out, self.signature)
        return bytes(out)

    def hash(self) -> bytes:
        return hashlib.sha256(self.marshal()).digest()


def unmarshal_tx(raw: bytes) -> Tx:
    body, pos = _get_bytes(raw, 0)
    auth, pos = _get_bytes(raw, pos)
    sig, pos = _get_bytes(raw, pos)
    if pos != len(raw):
        raise ValueError("trailing bytes after tx")
    # body
    bpos = 0
    n_msgs, bpos = _read_varint(body, bpos)
    msgs = []
    for _ in range(n_msgs):
        mraw, bpos = _get_bytes(body, bpos)
        msg, used = unmarshal_msg(mraw)
        if used != len(mraw):
            raise ValueError("trailing bytes in msg")
        msgs.append(msg)
    memo_b, bpos = _get_bytes(body, bpos)
    timeout_height, bpos = _read_varint(body, bpos)
    if bpos != len(body):
        raise ValueError("trailing bytes in tx body")
    # auth
    apos = 0
    fee_amount, apos = _read_varint(auth, apos)
    gas_limit, apos = _read_varint(auth, apos)
    pubkey, apos = _get_bytes(auth, apos)
    sequence, apos = _read_varint(auth, apos)
    account_number, apos = _read_varint(auth, apos)
    fee_granter, apos = _get_bytes(auth, apos)
    if apos != len(auth):
        raise ValueError("trailing bytes in tx auth")
    tx = Tx(
        tuple(msgs), Fee(fee_amount, gas_limit), pubkey, sequence,
        account_number, memo_b.decode(), sig, timeout_height, fee_granter,
    )
    # stash the verbatim wire slices: sign_bytes hashes THESE instead of
    # re-serializing (SignDoc semantics — the reference signs over the
    # raw BodyBytes/AuthInfoBytes from the wire, and re-encoding 512
    # proposal txs was a visible slice of FilterTxs host time)
    object.__setattr__(tx, "_wire_body", body)
    object.__setattr__(tx, "_wire_auth", auth)
    return tx
