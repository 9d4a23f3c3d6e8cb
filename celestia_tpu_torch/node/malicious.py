"""Malicious app fixtures: byzantine proposal handlers for adversarial tests.

Parity with test/util/malicious/: a wrapper around the real
App with pluggable bad PrepareProposal handlers (registry at app.go:38-42) —
an out-of-order square builder (out_of_order_builder.go:24-63) and a
data-root liar — plus an auto-accept ProcessProposal (app.go:92-96).  Used
to prove honest validators reject malicious blocks.

Re-homed from ``celestia_tpu/node/malicious.py``: the out-of-order square
is extended on the App's device (``dah.extend_block(bad_square,
device=app.device)``), so a byzantine proposal is built where an honest
one would be.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from celestia_tpu_torch.da import dah as dah_mod
from celestia_tpu_torch.da.square import Square, build as build_square
from celestia_tpu_torch.state.app import App, PreparedProposal

# handler name -> fn(app, txs) -> PreparedProposal
HANDLER_REGISTRY: Dict[str, Callable] = {}


def register_handler(name: str):
    def deco(fn):
        HANDLER_REGISTRY[name] = fn
        return fn

    return deco


@register_handler("out_of_order")
def out_of_order_prepare(app: App, txs: List[bytes]) -> PreparedProposal:
    """Build a square whose blob shares are NOT namespace-ordered (swap the
    first two blob sequences), then honestly commit to the malicious square.

    An honest validator reconstructs the canonical (sorted) square from the
    same txs and computes a different data root -> REJECT.
    """
    kept = app._filter_txs(txs)
    square, block_txs, _ = build_square(kept, app.max_effective_square_size())
    shares = list(square.shares)
    # find the first two distinct user-blob sequences and swap them
    starts = [
        i
        for i, s in enumerate(shares)
        if s.namespace.is_usable_by_users() and s.is_sequence_start
    ]
    if len(starts) < 2:
        raise ValueError(
            "out_of_order handler needs >= 2 user-blob sequences to reorder; "
            "drive it with at least two blob txs"
        )
    a, b = starts[0], starts[1]

    def seq_end(i):
        j = i + 1
        while j < len(shares) and (
            shares[j].namespace.raw == shares[i].namespace.raw
            and not shares[j].is_sequence_start
        ):
            j += 1
        return j

    ea, eb = seq_end(a), seq_end(b)
    shares = shares[:a] + shares[b:eb] + shares[ea:b] + shares[a:ea] + shares[eb:]
    bad_square = Square(tuple(shares), square.size)
    eds, dah = dah_mod.extend_block(bad_square, device=app.device)
    return PreparedProposal(block_txs, bad_square.size, dah.hash, eds, dah)


@register_handler("lying_data_root")
def lying_data_root_prepare(app: App, txs: List[bytes]) -> PreparedProposal:
    """Honest square, but the proposal lies about the data root."""
    proposal = App.prepare_proposal(app, txs)
    fake = bytes(32 - len(b"liar")) + b"liar"
    return PreparedProposal(
        proposal.block_txs, proposal.square_size, fake, proposal.eds, proposal.dah
    )


class MaliciousApp(App):
    """App with a pluggable byzantine PrepareProposal and an auto-accepting
    ProcessProposal (so the byzantine node votes for its own garbage)."""

    def __init__(self, *args, handler: str = "out_of_order", **kwargs):
        super().__init__(*args, **kwargs)
        if handler not in HANDLER_REGISTRY:
            raise KeyError(
                f"unknown malicious handler {handler!r}; "
                f"choose from {sorted(HANDLER_REGISTRY)}"
            )
        self._handler = HANDLER_REGISTRY[handler]

    def prepare_proposal(self, txs: List[bytes]) -> PreparedProposal:
        return self._handler(self, txs)

    def process_proposal(
        self, block_txs: List[bytes], square_size: int, data_root: bytes
    ) -> Tuple[bool, str]:
        return True, "malicious auto-accept"
