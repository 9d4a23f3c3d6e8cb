"""Minimal IBC transfer stack: channels, ICS-20 app module, middleware.

Role: the transport x/tokenfilter mounts on.  The reference wires its
middleware into ibc-go's transfer stack (app/app.go:71-78,
x/tokenfilter/ibc_middleware.go:38-80); here the same three layers exist
natively:

  ChannelKeeper  — channel registry, send/recv sequences, packet
                   commitments and acknowledgements (ICS-4 surface).
  TransferModule — ICS-20 escrow/mint semantics: native tokens escrow on
                   send and unescrow on return; foreign tokens would mint
                   prefixed vouchers on receive (on Celestia the token
                   filter forbids that branch); error acks refund.
  middleware     — any wrapper implementing on_recv_packet; the token
                   filter middleware rejects foreign tokens with an error
                   acknowledgement BEFORE the transfer module can mint.

An in-process Relayer connects two stacks for tests (the shape of ibc-go's
testing chains used by the reference's test/tokenfilter suite).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from celestia_tpu_torch.state.modules.tokenfilter import (
    Acknowledgement,
    FungibleTokenPacketData,
    NATIVE_DENOM,
    Packet,
    on_recv_packet as tokenfilter_policy,
)

TRANSFER_PORT = "transfer"


def escrow_address(port: str, channel: str) -> bytes:
    """Deterministic per-channel escrow account (ics20 escrow address)."""
    return hashlib.sha256(f"ics20-escrow/{port}/{channel}".encode()).digest()[:20]


@dataclass
class Channel:
    channel_id: str
    port: str
    counterparty_channel: str
    counterparty_port: str
    state: str = "OPEN"


class ChannelKeeper:
    """ICS-4 surface: channels, sequences, commitments, acks.

    With a KVStore attached (the app's "ibc" substore), every packet
    commitment, acknowledgement and receive receipt is ALSO written to
    merkleized state — which is what makes them PROVABLE to a
    counterparty light client (state.merkle proofs over the committed
    app hash; modules/ibc_client.py key layout).  Without a store the
    keeper works dict-only (standalone test stacks)."""

    def __init__(self, store=None):
        self.store = store
        self.channels: Dict[str, Channel] = {}
        self._next_seq: Dict[str, int] = {}
        self.commitments: Dict[Tuple[str, int], bytes] = {}
        self.acks: Dict[Tuple[str, int], Acknowledgement] = {}
        # outbound log relayers drain (packet-forward hops emit sends the
        # caller never sees, so the transport surfaces them here)
        self.sent: List[Tuple[Packet, int]] = []
        self._timed_out: set = set()
        self._received: set = set()

    def _skeys(self):
        from celestia_tpu_torch.state.modules import ibc_client as keys

        return keys

    def rehydrate(self) -> None:
        """Rebuild the in-memory guards from the merkleized store after a
        snapshot/disk restore: receipts (replay protection), commitments
        (ack/timeout claims), channels, send sequences and timed-out
        marks all survive a restart because they were mirrored to state —
        without this, a restored node would accept replays and refuse
        legitimate acks."""
        if self.store is None:
            return
        for k, v in self.store.iterate():
            parts = k.decode().split("/")
            if parts[0] == "channels" and len(parts) == 2:
                d = json.loads(v)
                self.channels[parts[1]] = Channel(
                    parts[1], d["port"], d["counterparty_channel"],
                    d["counterparty_port"], d["state"],
                )
                self._next_seq.setdefault(parts[1], 1)
            elif parts[0] == "nextseq" and len(parts) == 2:
                self._next_seq[parts[1]] = int.from_bytes(v, "big")
            elif parts[0] == "commitments" and len(parts) == 3:
                self.commitments[(parts[1], int(parts[2]))] = v
            elif parts[0] == "receipts" and len(parts) == 3:
                self._received.add((parts[1], int(parts[2])))
            elif parts[0] == "timedout" and len(parts) == 3:
                self._timed_out.add((parts[1], int(parts[2])))

    def open_channel(
        self, channel_id: str, counterparty_channel: str,
        port: str = TRANSFER_PORT, counterparty_port: str = TRANSFER_PORT,
    ) -> Channel:
        ch = Channel(channel_id, port, counterparty_channel, counterparty_port)
        self.channels[channel_id] = ch
        self._next_seq[channel_id] = 1
        if self.store is not None:
            keys = self._skeys()
            self.store.set(
                keys.channel_key(channel_id),
                json.dumps(
                    {
                        "port": port,
                        "counterparty_channel": counterparty_channel,
                        "counterparty_port": counterparty_port,
                        "state": ch.state,
                    }
                ).encode(),
            )
        return ch

    def send_packet(
        self, channel_id: str, data: bytes, timeout_height: int = 0
    ) -> Tuple[Packet, int]:
        ch = self.channels.get(channel_id)
        if ch is None or ch.state != "OPEN":
            raise ValueError(f"channel {channel_id} is not open")
        seq = self._next_seq[channel_id]
        self._next_seq[channel_id] = seq + 1
        packet = Packet(
            source_port=ch.port,
            source_channel=ch.channel_id,
            dest_port=ch.counterparty_port,
            dest_channel=ch.counterparty_channel,
            data=data,
            timeout_height=timeout_height,
        )
        keys = self._skeys()
        commitment = keys.packet_commitment(data, timeout_height)
        self.commitments[(channel_id, seq)] = commitment
        if self.store is not None:
            self.store.set(keys.commitment_key(channel_id, seq), commitment)
            self.store.set(
                keys.nextseq_key(channel_id),
                self._next_seq[channel_id].to_bytes(8, "big"),
            )
        self.sent.append((packet, seq))
        return packet, seq

    def write_ack(self, channel_id: str, seq: int, ack: Acknowledgement) -> None:
        self.acks[(channel_id, seq)] = ack
        if self.store is not None:
            keys = self._skeys()
            self.store.set(
                keys.ack_key(channel_id, seq),
                hashlib.sha256(keys.ack_bytes(ack)).digest(),
            )

    def write_receipt(self, channel_id: str, seq: int) -> None:
        """Replay guard: one receive per (channel, seq), provable."""
        if (channel_id, seq) in self._received:
            raise ValueError(
                f"packet {channel_id}#{seq} was already received"
            )
        self._received.add((channel_id, seq))
        if self.store is not None:
            self.store.set(
                self._skeys().receipt_key(channel_id, seq), b"\x01"
            )

    def has_receipt(self, channel_id: str, seq: int) -> bool:
        return (channel_id, seq) in self._received

    def claim_commitment(
        self, channel_id: str, seq: int, data: bytes, timeout_height: int = 0
    ) -> None:
        """Check-and-delete: the stored commitment must exist and match the
        packet data + timeout (ibc-go's AcknowledgePacket/TimeoutPacket
        verify the same before the app callback).  A missing commitment
        means the packet's lifecycle already completed — acting on it
        again would refund twice, so this RAISES instead of silently
        ignoring."""
        key = (channel_id, seq)
        stored = self.commitments.get(key)
        if stored is None:
            raise ValueError(
                f"no commitment for packet {channel_id}#{seq}: already "
                f"acked or timed out"
            )
        if stored != self._skeys().packet_commitment(data, timeout_height):
            raise ValueError(f"commitment mismatch for packet {channel_id}#{seq}")
        del self.commitments[key]
        if self.store is not None:
            self.store.delete(self._skeys().commitment_key(channel_id, seq))

    # sequences whose timeout was processed: a late delivery must refuse
    # (the source already refunded)
    def mark_timed_out(self, channel_id: str, seq: int) -> None:
        self._timed_out.add((channel_id, seq))
        if self.store is not None:
            self.store.set(
                self._skeys().timedout_key(channel_id, seq), b"\x01"
            )

    def is_timed_out(self, channel_id: str, seq: int) -> bool:
        return (channel_id, seq) in self._timed_out


class TransferModule:
    """ICS-20 application module over a denom-aware bank."""

    def __init__(self, bank, channels: ChannelKeeper, chain_name: str = "chain"):
        self.bank = bank
        self.channels = channels
        self.chain_name = chain_name

    # -- send side -----------------------------------------------------

    def send_transfer(
        self,
        sender: bytes,
        receiver: str,
        amount: int,
        denom: str,
        channel_id: str,
        memo: str = "",
        timeout_height: int = 0,
    ) -> Tuple[Packet, int]:
        """memo rides inside the committed packet data (it carries
        packet-forward instructions, so it MUST be covered by the
        commitment — a relayer-injected memo would fail the claim)."""
        ch = self.channels.channels.get(channel_id)
        if ch is None:
            raise ValueError(f"unknown channel {channel_id}")
        prefix = f"{ch.port}/{ch.channel_id}/"
        if denom.startswith(prefix):
            # voucher going home: burn it here (the counterparty unescrows)
            self.bank.burn_denom(sender, amount, denom)
        else:
            # source-chain token: escrow it
            self.bank.send_denom(
                sender, escrow_address(ch.port, ch.channel_id), amount, denom
            )
        data = FungibleTokenPacketData(
            denom=denom,
            amount=str(amount),
            sender=sender.hex(),
            receiver=receiver,
            memo=memo,
        ).to_json()
        return self.channels.send_packet(channel_id, data, timeout_height)

    # -- receive side --------------------------------------------------

    def on_recv_packet(self, packet: Packet) -> Acknowledgement:
        try:
            data = FungibleTokenPacketData.from_json(packet.data)
            amount = int(data.amount)
            receiver = bytes.fromhex(data.receiver)
        except (ValueError, KeyError):
            return Acknowledgement(False, "cannot unmarshal ICS-20 packet data")
        prefix = f"{packet.source_port}/{packet.source_channel}/"
        try:
            if data.denom.startswith(prefix):
                # token returning to its source: unescrow the original
                base = data.denom[len(prefix):]
                self.bank.send_denom(
                    escrow_address(packet.dest_port, packet.dest_channel),
                    receiver, amount, base,
                )
            else:
                # foreign token: mint a voucher with this hop's prefix
                voucher = (
                    f"{packet.dest_port}/{packet.dest_channel}/{data.denom}"
                )
                self.bank.mint_denom(receiver, amount, voucher)
        except ValueError as e:
            return Acknowledgement(False, str(e))
        return Acknowledgement(True)

    # -- ack / refund --------------------------------------------------

    def on_acknowledgement(
        self, packet: Packet, seq: int, ack: Acknowledgement
    ) -> None:
        # check-and-claim guards replay: a second ack (or ack-after-
        # timeout) raises instead of refunding twice
        self.channels.claim_commitment(
            packet.source_channel, seq, packet.data, packet.timeout_height
        )
        if ack.success:
            return
        self._refund(packet)

    def on_timeout_packet(self, packet: Packet, seq: int) -> None:
        """ICS-4 timeout: refund like an error ack (ibc-go's transfer
        OnTimeoutPacket).  The commitment claim rejects timeout-after-ack,
        double-timeout, and fabricated packets — the refund only ever
        fires once per real in-flight send."""
        self.channels.claim_commitment(
            packet.source_channel, seq, packet.data, packet.timeout_height
        )
        self._refund(packet)

    def _refund(self, packet: Packet) -> None:
        """Reverse the send-side escrow/burn."""
        try:
            data = FungibleTokenPacketData.from_json(packet.data)
        except (ValueError, KeyError):
            return
        sender = bytes.fromhex(data.sender)
        amount = int(data.amount)
        prefix = f"{packet.source_port}/{packet.source_channel}/"
        if data.denom.startswith(prefix):
            self.bank.mint_denom(sender, amount, data.denom)  # re-mint voucher
        else:
            self.bank.send_denom(
                escrow_address(packet.source_port, packet.source_channel),
                sender, amount, data.denom,
            )


class TokenFilterMiddleware:
    """tokenFilterMiddleware parity (ibc_middleware.go:38-80): wraps an IBC
    app module; foreign tokens get an error acknowledgement and NEVER reach
    the wrapped module's mint path."""

    def __init__(self, app_module: TransferModule):
        self.app = app_module

    def on_recv_packet(self, packet: Packet) -> Acknowledgement:
        verdict = tokenfilter_policy(packet)
        if not verdict.success:
            return verdict
        return self.app.on_recv_packet(packet)

    def __getattr__(self, name):
        return getattr(self.app, name)


def forward_address(channel: str, receiver: str) -> bytes:
    """Deterministic intermediate account the forward hop settles through
    (packet-forward-middleware derives one the same way)."""
    return hashlib.sha256(f"pfm-intermediate/{channel}/{receiver}".encode()).digest()[:20]


class PacketForwardMiddleware:
    """packet-forward-middleware parity (the reference wires
    PacketForwardKeeper, app/app.go:219): an inbound ICS-20 packet whose
    memo carries {"forward": {"receiver", "channel"}} is received into a
    deterministic intermediate account and immediately re-sent out the
    requested channel toward the final receiver.  A failed onward send
    refunds by acking the ORIGINAL packet as an error, so the upstream
    chain's own refund path fires — the same fail-safe the real PFM uses."""

    def __init__(self, app_module, transfer: TransferModule):
        self.app = app_module  # next layer inward (e.g. token filter)
        self.transfer = transfer  # for the onward hop

    def on_recv_packet(self, packet: Packet) -> Acknowledgement:
        try:
            data = FungibleTokenPacketData.from_json(packet.data)
            memo = json.loads(data.memo) if data.memo else {}
        except (ValueError, KeyError):
            return self.app.on_recv_packet(packet)
        fwd = memo.get("forward") if isinstance(memo, dict) else None
        if not fwd:
            return self.app.on_recv_packet(packet)
        try:
            final_receiver = fwd["receiver"]
            out_channel = fwd["channel"]
        except (KeyError, TypeError):
            return Acknowledgement(False, "malformed forward memo")
        # hop 1: receive into the intermediate account via the inner stack
        # (token filter still applies — a forbidden token never forwards)
        intermediate = forward_address(out_channel, final_receiver)
        hop_packet = Packet(
            packet.source_port, packet.source_channel,
            packet.dest_port, packet.dest_channel,
            FungibleTokenPacketData(
                data.denom, data.amount, data.sender, intermediate.hex(),
            ).to_json(),
        )
        ack = self.app.on_recv_packet(hop_packet)
        if not ack.success:
            return ack
        # hop 2: send onward; the denom as held HERE gains/loses the hop
        # prefix exactly as the transfer module's receive computed it
        prefix = f"{packet.source_port}/{packet.source_channel}/"
        if data.denom.startswith(prefix):
            local_denom = data.denom[len(prefix):]
        else:
            local_denom = f"{packet.dest_port}/{packet.dest_channel}/{data.denom}"
        try:
            self.transfer.send_transfer(
                intermediate, final_receiver, int(data.amount),
                local_denom, out_channel,
            )
        except ValueError as e:
            # onward hop failed: error-acking the original makes the sender
            # chain refund, so the hop-1 credit must leave circulation HERE
            # or the tokens exist on both chains (supply inflation)
            amount = int(data.amount)
            if data.denom.startswith(prefix):
                # hop 1 unescrowed a returning token: re-escrow it
                self.transfer.bank.send_denom(
                    intermediate,
                    escrow_address(packet.dest_port, packet.dest_channel),
                    amount, local_denom,
                )
            else:
                # hop 1 minted a voucher: burn it
                self.transfer.bank.burn_denom(intermediate, amount, local_denom)
            return Acknowledgement(False, f"forward failed: {e}")
        return Acknowledgement(True)

    def __getattr__(self, name):
        return getattr(self.app, name)


ICA_HOST_PORT = "icahost"
ICA_CONTROLLER_PORT = "icacontroller"


def interchain_account_address(connection: str, owner: str) -> bytes:
    """Deterministic ICS-27 interchain account address for (connection,
    controller-side owner)."""
    return hashlib.sha256(
        f"ics27-account/{connection}/{owner}".encode()
    ).digest()[:20]


class ICAControllerModule:
    """ICS-27 controller: drives interchain accounts on counterparty
    hosts (the other half of ICAHostModule; the reference wires only the
    host keeper, app/app.go:203 — the controller lives on the chains
    whose users act THROUGH Celestia-hosted accounts, and is provided
    here so two framework chains can pair up in tests and devnets)."""

    def __init__(self, channels: ChannelKeeper):
        self.channels = channels
        # (channel, seq) -> Acknowledgement once the host answered
        self.results: Dict[Tuple[str, int], Acknowledgement] = {}

    def interchain_address(self, connection: str, owner: str) -> bytes:
        """The account this owner controls on the host (same derivation)."""
        return interchain_account_address(connection, owner)

    def send_tx(
        self,
        owner: str,
        connection: str,
        channel_id: str,
        msgs: List,
    ) -> Tuple[Packet, int]:
        """Package msgs into an ica_tx packet on an icacontroller channel.
        Every msg must be signed-for by the owner's interchain account —
        the host enforces it too, but failing early here saves a round
        trip."""
        from celestia_tpu_torch.state.tx import marshal_msg

        ch = self.channels.channels.get(channel_id)
        if (
            ch is None
            or ch.port != ICA_CONTROLLER_PORT
            or ch.counterparty_port != ICA_HOST_PORT
            or ch.state != "OPEN"
        ):
            raise ValueError(
                f"{channel_id} is not an open {ICA_CONTROLLER_PORT}->"
                f"{ICA_HOST_PORT} channel"
            )
        if not msgs:
            # ibc-go's ICS-27 rejects empty tx data; a success ack for a
            # no-op would mask the caller's empty-batch bug
            raise ValueError("ica_tx needs at least one message")
        ica = self.interchain_address(connection, owner)
        for m in msgs:
            if any(s != ica for s in m.signers()):
                raise ValueError(
                    "msg signer is not the owner's interchain account"
                )
        data = json.dumps(
            {
                "type": "ica_tx",
                "owner": owner,
                "connection": connection,
                "msgs": [marshal_msg(m).hex() for m in msgs],
            }
        ).encode()
        return self.channels.send_packet(channel_id, data)

    def on_acknowledgement(
        self, packet: Packet, seq: int, ack: Acknowledgement
    ) -> None:
        self.channels.claim_commitment(
            packet.source_channel, seq, packet.data, packet.timeout_height
        )
        self.results[(packet.source_channel, seq)] = ack

    def on_timeout_packet(self, packet: Packet, seq: int) -> None:
        self.channels.claim_commitment(
            packet.source_channel, seq, packet.data, packet.timeout_height
        )
        self.results[(packet.source_channel, seq)] = Acknowledgement(
            False, "packet timed out"
        )


class ICAHostModule:
    """ICS-27 host parity (the reference wires ICAHostKeeper,
    app/app.go:203): executes transactions sent by a counterparty
    controller chain under that controller's interchain account.

    Packet data: {"type": "ica_tx", "owner": ..., "connection": ...,
    "msgs": [hex-marshaled msgs]}.  Every msg's declared signer must BE the
    derived interchain account — a controller can never act as anyone else.
    Execution is atomic: any failure rolls back the whole packet and
    returns an error ack."""

    def __init__(self, app, allow_msgs: Optional[List[int]] = None):
        self.app = app  # the state-machine App (msg dispatch + stores)
        # host-side allowlist of msg TYPE ids (SDK ica host AllowMessages);
        # None = allow all registered msgs
        self.allow_msgs = allow_msgs

    def on_recv_packet(self, packet: Packet) -> Acknowledgement:
        from celestia_tpu_torch.state.ante import GasMeter
        from celestia_tpu_torch.state.tx import unmarshal_msg

        try:
            d = json.loads(packet.data)
            assert d.get("type") == "ica_tx"
            owner = d["owner"]
            connection = d["connection"]
            raw_msgs = [bytes.fromhex(m) for m in d["msgs"]]
        except (ValueError, KeyError, AssertionError):
            return Acknowledgement(False, "cannot unmarshal ICS-27 packet data")
        ica_addr = interchain_account_address(connection, owner)
        msgs = []
        try:
            for raw in raw_msgs:
                msg, used = unmarshal_msg(raw)
                if used != len(raw):
                    raise ValueError("trailing bytes in ICA msg")
                msgs.append(msg)
        except ValueError as e:
            return Acknowledgement(False, f"bad ICA msg: {e}")
        for msg in msgs:
            if self.allow_msgs is not None and msg.TYPE not in self.allow_msgs:
                return Acknowledgement(
                    False, f"msg type {msg.TYPE} not allowed on this host"
                )
            if any(s != ica_addr for s in msg.signers()):
                return Acknowledgement(
                    False, "ICA msg signer is not the interchain account"
                )
        # atomic execution on a branch (ibc-go's cache-ctx commit shape)
        branch = self.app.store.branch()
        saved = self.app.store
        self.app.store = branch
        self.app._wire_keepers(rebuild_ibc=False)
        try:
            meter = GasMeter(10_000_000)
            for msg in msgs:
                self.app._execute_msg(msg, meter)
        except Exception as e:
            return Acknowledgement(False, f"ICA execution failed: {e}")
        else:
            saved.write_back(branch)
            return Acknowledgement(True)
        finally:
            self.app.store = saved
            self.app._wire_keepers(rebuild_ibc=False)


@dataclass
class IBCStack:
    """One chain's transfer stack: channels + middleware-wrapped module.

    Stack order (outermost first) mirrors the reference's app.go wiring:
    packet-forward -> token filter -> ICS-20 transfer; the ICS-27 host
    module listens on its own port when an App is attached."""

    name: str
    bank: object
    channels: ChannelKeeper = None
    filtered: bool = False
    forwarding: bool = True
    app: object = None  # the state-machine App (enables the ICA host)
    store: object = None  # the app's "ibc" KVStore (provable commitments)

    def __post_init__(self):
        if self.channels is None:
            self.channels = ChannelKeeper(store=self.store)
            # a restored node's guards come back from merkleized state
            self.channels.rehydrate()
        from celestia_tpu_torch.state.modules.ibc_client import ConnectionKeeper

        # client state (valsets, consensus states, the frozen flag) and
        # channel bindings persist in the same "ibc" substore as the
        # channel keeper's receipts — a restored node's frozen client
        # stays frozen (disjoint key prefixes; ibc_client.rehydrate)
        self.connections = ConnectionKeeper(store=self.store)
        self.connections.rehydrate()
        transfer = TransferModule(self.bank, self.channels, self.name)
        module = TokenFilterMiddleware(transfer) if self.filtered else transfer
        if self.forwarding:
            module = PacketForwardMiddleware(module, transfer)
        self.module = module
        self.ica_host = ICAHostModule(self.app) if self.app is not None else None
        self.ica_controller = ICAControllerModule(self.channels)

    def rebind(self, store, bank) -> None:
        """Swap the underlying KVStore/bank handles without rebuilding or
        rescanning in-memory state.

        The deliver path branch-swaps the app's store around every tx
        (state/app.py _wire_keepers); rebuilding the stack there would
        pay a full "ibc" substore scan + JSON decode per tx for nothing —
        no msg mutates IBC in-memory state, so only the handles the next
        WRITE goes through need to move.  Full rebuilds (with rehydrate)
        remain the restore/import path."""
        self.store = store
        self.bank = bank
        self.channels.store = store
        self.connections.store = store
        for client in self.connections.clients.values():
            client.store = store
        # the one TransferModule instance is shared by every middleware
        # layer (token filter wraps it, PFM aliases it as .transfer)
        mod = self.module
        while mod is not None and not isinstance(mod, TransferModule):
            mod = getattr(mod, "app", None)
        if mod is not None:
            mod.bank = bank

    def on_recv_packet(self, packet: Packet) -> Acknowledgement:
        """Port-level dispatch (IBC router role)."""
        if packet.dest_port == ICA_HOST_PORT:
            if self.ica_host is None:
                return Acknowledgement(False, "ICA host not enabled")
            return self.ica_host.on_recv_packet(packet)
        return self.module.on_recv_packet(packet)

    def app_module_for(self, packet: Packet):
        """The module owning a packet's SOURCE port (ack/timeout router)."""
        if packet.source_port == ICA_CONTROLLER_PORT:
            return self.ica_controller
        return self.module


class Relayer:
    """In-process packet relay between two stacks (ibc-go testing shape)."""

    def __init__(self, a: IBCStack, b: IBCStack,
                 channel_a: str = "channel-0", channel_b: str = "channel-0"):
        self.a, self.b = a, b
        self.channel_a, self.channel_b = channel_a, channel_b
        a.channels.open_channel(channel_a, channel_b)
        b.channels.open_channel(channel_b, channel_a)

    def relay(self, src: IBCStack, packet: Packet, seq: int) -> Acknowledgement:
        dst = self.b if src is self.a else self.a
        if dst.channels.is_timed_out(packet.dest_channel, seq):
            # the source already refunded on timeout; executing the
            # receive now would double-credit — refuse outright
            raise ValueError(
                f"packet {packet.dest_channel}#{seq} timed out; receive refused"
            )
        ack = dst.on_recv_packet(packet)  # port-level router (ICA vs ICS-20)
        dst.channels.write_ack(packet.dest_channel, seq, ack)
        src.app_module_for(packet).on_acknowledgement(packet, seq, ack)
        return ack

    def timeout(self, src: IBCStack, packet: Packet, seq: int) -> None:
        """Relayer processes a timeout: the destination marks the sequence
        closed (a late delivery is refused from now on), then the source
        refunds — once, enforced by the commitment claim."""
        dst = self.b if src is self.a else self.a
        dst.channels.mark_timed_out(packet.dest_channel, seq)
        src.app_module_for(packet).on_timeout_packet(packet, seq)


def recv_packet_verified(
    stack: IBCStack, packet: Packet, seq: int, proof: dict, proof_height: int
) -> Acknowledgement:
    """Proof-gated receive (ibc-go core RecvPacket): before ANY app
    callback runs, the packet must be proven committed on the
    counterparty — a merkle membership proof of
    commitments/{source_channel}/{seq} == sha256(packet.data) in the
    counterparty's "ibc" store, verified against the light client bound
    to the destination channel.  A forged, tampered or replayed packet
    never reaches the transfer module.  Raises on verification failure
    (the relayer is misbehaving; there is nothing to ack)."""
    from celestia_tpu_torch.state.modules.ibc_client import (
        ClientError,
        commitment_key,
    )

    client = stack.connections.client_for_channel(packet.dest_channel)
    if client is None:
        raise ClientError(
            f"channel {packet.dest_channel} is not bound to a client"
        )
    # the packet's routing must match the channel REGISTRY, not the
    # relayer's claims: the proven commitment key is scoped to the source
    # channel only, so without this check one committed packet could be
    # delivered on every destination channel bound to the same client
    # (cross-channel replay; ibc-go checks Counterparty.ChannelId in
    # RecvPacket the same way)
    ch = stack.channels.channels.get(packet.dest_channel)
    if ch is None or ch.state != "OPEN":
        raise ClientError(f"channel {packet.dest_channel} is not open")
    if (
        ch.counterparty_channel != packet.source_channel
        or ch.counterparty_port != packet.source_port
        or ch.port != packet.dest_port
    ):
        raise ClientError(
            "packet routing does not match the channel's counterparty"
        )
    if stack.channels.has_receipt(packet.dest_channel, seq):
        raise ClientError(f"packet {packet.dest_channel}#{seq} already received")
    # ICS-4 timeout: once THIS chain's height passes the packet's
    # timeout, receiving is deterministically refused — which is what
    # makes the source side's absence-proof refund safe (the packet can
    # never be delivered after the proven height)
    if packet.timeout_height and stack.app is not None:
        if stack.app.store.last_height >= packet.timeout_height:
            raise ClientError(
                f"packet timed out at height {packet.timeout_height}"
            )
    from celestia_tpu_torch.state.modules.ibc_client import packet_commitment

    client.verify_membership(
        proof_height,
        commitment_key(packet.source_channel, seq),
        packet_commitment(packet.data, packet.timeout_height),
        proof,
    )
    stack.channels.write_receipt(packet.dest_channel, seq)
    ack = stack.on_recv_packet(packet)
    stack.channels.write_ack(packet.dest_channel, seq, ack)
    return ack


def ack_packet_verified(
    stack: IBCStack,
    packet: Packet,
    seq: int,
    ack: Acknowledgement,
    proof: dict,
    proof_height: int,
) -> None:
    """Proof-gated acknowledgement (ibc-go core AcknowledgePacket): the
    claimed ack must be proven written on the counterparty before the
    send side acts on it — a lying relayer cannot trigger a refund (error
    ack) or suppress one (forged success)."""
    from celestia_tpu_torch.state.modules.ibc_client import (
        ClientError,
        ack_bytes,
        ack_key,
    )

    client = stack.connections.client_for_channel(packet.source_channel)
    if client is None:
        raise ClientError(
            f"channel {packet.source_channel} is not bound to a client"
        )
    # pin the ack's location to OUR channel's registered counterparty —
    # a relayer-chosen dest_channel could otherwise prove some OTHER
    # channel's success ack and suppress this packet's refund
    ch = stack.channels.channels.get(packet.source_channel)
    if ch is None:
        raise ClientError(f"unknown channel {packet.source_channel}")
    if (
        ch.counterparty_channel != packet.dest_channel
        or ch.counterparty_port != packet.dest_port
        or ch.port != packet.source_port
    ):
        raise ClientError(
            "ack routing does not match the channel's counterparty"
        )
    client.verify_membership(
        proof_height,
        ack_key(packet.dest_channel, seq),
        hashlib.sha256(ack_bytes(ack)).digest(),
        proof,
    )
    stack.app_module_for(packet).on_acknowledgement(packet, seq, ack)


def timeout_packet_verified(
    stack: IBCStack,
    packet: Packet,
    seq: int,
    absence_proof: dict,
    proof_height: int,
) -> None:
    """Proof-gated timeout (ibc-go core TimeoutPacket): refund only with
    an ABSENCE proof that the destination never wrote a receive receipt
    for this packet, at a proven height at or past the packet's timeout.
    Because the destination deterministically refuses receives once its
    height passes timeout_height (recv_packet_verified), a packet proven
    unreceived at such a height can never be delivered later — the refund
    cannot double-spend."""
    from celestia_tpu_torch.state.modules.ibc_client import (
        ClientError,
        receipt_key,
    )

    if not packet.timeout_height:
        raise ClientError("packet has no timeout; it cannot be timed out")
    client = stack.connections.client_for_channel(packet.source_channel)
    if client is None:
        raise ClientError(
            f"channel {packet.source_channel} is not bound to a client"
        )
    ch = stack.channels.channels.get(packet.source_channel)
    if ch is None:
        raise ClientError(f"unknown channel {packet.source_channel}")
    if (
        ch.counterparty_channel != packet.dest_channel
        or ch.counterparty_port != packet.dest_port
        or ch.port != packet.source_port
    ):
        raise ClientError(
            "timeout routing does not match the channel's counterparty"
        )
    # the proven height must itself be past the timeout: consensus state
    # at H proves the destination's state as of H-1
    if proof_height - 1 < packet.timeout_height:
        raise ClientError(
            f"proof height {proof_height} does not show the timeout "
            f"({packet.timeout_height}) elapsed"
        )
    client.verify_non_membership(
        proof_height,
        receipt_key(packet.dest_channel, seq),
        absence_proof,
    )
    stack.app_module_for(packet).on_timeout_packet(packet, seq)


class SecureRelayer:
    """An UNTRUSTED relayer between two App-backed chains: it moves
    (header, certificate) pairs to update clients and (packet, proof)
    pairs to deliver — every byte it carries is verified by the receiving
    chain.  chain handles must expose .app (the App) and .header_and_cert
    (height -> (header_fields, precommit wires)); see
    tests/test_ibc_light_client.py for the BFT-network-backed harness."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def _other(self, chain):
        return self.b if chain is self.a else self.a

    def update_client(self, dst_chain, src_chain, height: int) -> int:
        header, cert = src_chain.header_and_cert(height)
        client = dst_chain.client_of_counterparty
        return client.update(header, cert)

    def relay(self, src_chain, packet: Packet, seq: int) -> Acknowledgement:
        """Full verified lifecycle: commit the send, prove the commitment
        to the destination, receive, commit the ack, prove it back.

        Height arithmetic (Tendermint convention): state written before
        block H is committed in app_hash(H); the header at H+1 carries
        prev_app_hash = app_hash(H); so a proof generated at H verifies
        against the destination client's consensus state at H+1."""
        from celestia_tpu_torch.state.modules.ibc_client import ack_key, commitment_key

        dst_chain = self._other(src_chain)
        # 1. commit the send, then the header that proves it
        src_chain.commit_block()  # height H: includes the commitment
        src_chain.commit_block()  # height H+1: header proves app_hash(H)
        h = src_chain.app.store.last_height - 1
        self.update_client(dst_chain, src_chain, h + 1)
        proof = src_chain.app.store.prove(
            "ibc", commitment_key(packet.source_channel, seq), h
        )
        ack = recv_packet_verified(dst_chain.stack, packet, seq, proof, h + 1)
        # 2. destination commits the ack, then proves it back
        dst_chain.commit_block()
        dst_chain.commit_block()
        d = dst_chain.app.store.last_height - 1
        self.update_client(src_chain, dst_chain, d + 1)
        ack_proof = dst_chain.app.store.prove(
            "ibc", ack_key(packet.dest_channel, seq), d
        )
        ack_packet_verified(src_chain.stack, packet, seq, ack, ack_proof, d + 1)
        return ack

    def timeout(self, src_chain, packet: Packet, seq: int) -> None:
        """Trustless timeout: wait for the destination to provably pass
        the packet's timeout height, then refund against an ABSENCE proof
        of the receive receipt."""
        from celestia_tpu_torch.state.modules.ibc_client import receipt_key

        dst_chain = self._other(src_chain)
        while dst_chain.app.store.last_height < packet.timeout_height:
            dst_chain.commit_block()
        dst_chain.commit_block()  # header proving the post-timeout state
        d = dst_chain.app.store.last_height - 1
        self.update_client(src_chain, dst_chain, d + 1)
        proof = dst_chain.app.store.prove(
            "ibc", receipt_key(packet.dest_channel, seq), d
        )
        timeout_packet_verified(src_chain.stack, packet, seq, proof, d + 1)
