"""x/authz equivalent: message-execution grants (granter authorizes a
grantee to execute messages on its behalf).

Parity role: the cosmos-sdk authz keeper the reference wires at
app/app.go:292-294 (authzkeeper.NewKeeper + msg service
router).  Two authorization shapes mirror the SDK's: GenericAuthorization
(any message of a declared type) and SendAuthorization (bank sends up to a
decrementing spend limit).  MsgExec carries the wrapped inner messages; the
app dispatches each through its normal handler after the grant check, so an
exec'd message is indistinguishable from a directly-signed one at the
keeper layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from celestia_tpu_torch.da.shares import _read_varint, _varint
from celestia_tpu_torch.state.store import KVStore

_GRANT_PREFIX = b"az/"


class AuthzError(ValueError):
    pass


@dataclass
class Authorization:
    """One grant record keyed by (granter, grantee, msg_type).

    spend_limit is only meaningful for MsgSend grants (SendAuthorization);
    0 = unlimited (GenericAuthorization semantics)."""

    msg_type: int  # Msg.TYPE id
    spend_limit: int = 0
    expiration_ns: int = 0  # 0 = never expires

    def marshal(self) -> bytes:
        return bytes(
            _varint(self.msg_type)
            + _varint(self.spend_limit)
            + _varint(self.expiration_ns)
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Authorization":
        pos = 0
        t, pos = _read_varint(raw, pos)
        lim, pos = _read_varint(raw, pos)
        exp, pos = _read_varint(raw, pos)
        return cls(t, lim, exp)


class AuthzKeeper:
    def __init__(self, store: KVStore):
        self.store = store

    def _key(self, granter: bytes, grantee: bytes, msg_type: int) -> bytes:
        return _GRANT_PREFIX + granter + grantee + _varint(msg_type)

    def grant(self, granter: bytes, grantee: bytes, auth: Authorization) -> None:
        if granter == grantee:
            raise AuthzError("cannot self-grant an authorization")
        self.store.set(self._key(granter, grantee, auth.msg_type), auth.marshal())

    def revoke(self, granter: bytes, grantee: bytes, msg_type: int) -> None:
        key = self._key(granter, grantee, msg_type)
        if self.store.get(key) is None:
            raise AuthzError("authorization not found")
        self.store.delete(key)

    def get(
        self, granter: bytes, grantee: bytes, msg_type: int
    ) -> Optional[Authorization]:
        raw = self.store.get(self._key(granter, grantee, msg_type))
        return Authorization.unmarshal(raw) if raw is not None else None

    def grants_by_granter(self, granter: bytes) -> List[Tuple[bytes, Authorization]]:
        return [
            (k[len(_GRANT_PREFIX) + 20 : len(_GRANT_PREFIX) + 40],
             Authorization.unmarshal(v))
            for k, v in self.store.iterate(_GRANT_PREFIX + granter)
        ]

    def check_and_consume(
        self,
        granter: bytes,
        grantee: bytes,
        msg,
        now_ns: int,
    ) -> None:
        """Authorize one inner message of a MsgExec; mutates spend limits
        (SDK Authorization.Accept).  Raises AuthzError when the grant is
        missing, expired, or exhausted."""
        key = self._key(granter, grantee, msg.TYPE)
        auth = self.get(granter, grantee, msg.TYPE)
        if auth is None:
            raise AuthzError(
                f"no authorization for msg type {type(msg).__name__} from "
                f"{granter.hex()} to {grantee.hex()}"
            )
        if auth.expiration_ns and now_ns >= auth.expiration_ns:
            self.store.delete(key)
            raise AuthzError("authorization expired")
        if auth.spend_limit:
            amount = getattr(msg, "amount", None)
            if amount is None:
                raise AuthzError(
                    "spend-limited authorization on a message without an amount"
                )
            if amount > auth.spend_limit:
                raise AuthzError(
                    f"amount {amount}utia exceeds authorization "
                    f"{auth.spend_limit}utia"
                )
            auth.spend_limit -= amount
            if auth.spend_limit == 0:
                self.store.delete(key)
                return
            self.store.set(key, auth.marshal())
