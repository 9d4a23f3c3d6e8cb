"""x/tokenfilter: IBC middleware rejecting inbound non-native tokens.

Parity with x/tokenfilter/ibc_middleware.go:38-80: Celestia
only accepts transfer packets whose token is native TIA returning home
(denom prefixed with this chain's port/channel, per ICS-20 denom-trace
rules); any foreign token is rejected with an error acknowledgement instead
of being minted as a voucher.

The IBC transport itself is out of scope for this node (no IBC channels are
wired yet); the middleware is a pure function over ICS-20 packet data so the
policy is testable and ready to mount on a future transfer stack.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

NATIVE_DENOM = "utia"


@dataclass(frozen=True)
class FungibleTokenPacketData:
    """ICS-20 packet payload (memo carries packet-forward instructions)."""

    denom: str
    amount: str
    sender: str
    receiver: str
    memo: str = ""

    @classmethod
    def from_json(cls, raw: bytes) -> "FungibleTokenPacketData":
        d = json.loads(raw)
        return cls(
            d["denom"], d["amount"], d["sender"], d["receiver"],
            d.get("memo", ""),
        )

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "denom": self.denom,
                "amount": self.amount,
                "sender": self.sender,
                "receiver": self.receiver,
                "memo": self.memo,
            },
            sort_keys=True,
        ).encode()


@dataclass(frozen=True)
class Packet:
    source_port: str
    source_channel: str
    dest_port: str
    dest_channel: str
    data: bytes
    # ICS-4 timeout: the packet is undeliverable once the DESTINATION
    # chain's height exceeds this (0 = no timeout).  Covered by the
    # packet commitment, so a relayer cannot alter it.
    timeout_height: int = 0


@dataclass(frozen=True)
class Acknowledgement:
    success: bool
    error: str = ""


def on_recv_packet(packet: Packet) -> Acknowledgement:
    """tokenFilterMiddleware.OnRecvPacket parity: accept only returning
    native tokens.

    In ICS-20, a token that originated HERE and is coming back carries a
    denom prefixed with the packet's source port/channel (the counterparty
    held it as a voucher).  Anything else is a foreign token -> reject.
    """
    try:
        data = FungibleTokenPacketData.from_json(packet.data)
    except (ValueError, KeyError):
        return Acknowledgement(False, "cannot unmarshal ICS-20 packet data")
    prefix = f"{packet.source_port}/{packet.source_channel}/"
    if data.denom.startswith(prefix):
        # strip one hop; if what remains is the native denom (possibly with
        # no further hops), this is TIA returning home
        remainder = data.denom[len(prefix):]
        if remainder == NATIVE_DENOM:
            return Acknowledgement(True)
        # still a returning voucher of something we minted? only native is held
        return Acknowledgement(
            False, f"only native {NATIVE_DENOM} may return; got {remainder!r}"
        )
    return Acknowledgement(
        False,
        f"token {data.denom!r} originating elsewhere is not accepted by this chain",
    )
