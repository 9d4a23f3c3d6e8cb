"""Post-handler chain: decorators that run AFTER a tx's messages execute.

Parity with app/posthandler/posthandler.go:1-12 — the
reference's chain is deliberately EMPTY (a placeholder for future
post-execution logic such as fee refunds or tip routing), but the
chain MECHANISM is wired: BaseApp calls the post handler on the message
branch after successful execution, so post-decorator writes commit (or
roll back) atomically with the tx.  This module mirrors that: the
default chain is empty, `new_post_handler()` composes any registered
decorators in order, and App.deliver_tx runs the chain on the message
branch after the last message succeeds (state/app.py).

A post decorator is `fn(ctx: PostContext) -> None`; raising rolls the
whole tx back (same atomicity as a message failure).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Tuple


@dataclass
class PostContext:
    """What a post decorator sees: the executed tx, its events, and the
    app (for keeper access on the current — message-branch — store)."""

    tx: object
    app: object
    events: List[dict] = field(default_factory=list)
    gas_meter: object = None


PostDecorator = Callable[[PostContext], None]

# posthandler.go:10 — the default chain is empty on purpose
DEFAULT_POST_DECORATORS: Tuple[PostDecorator, ...] = ()


def new_post_handler(
    decorators: Tuple[PostDecorator, ...] = DEFAULT_POST_DECORATORS,
) -> Callable[[PostContext], None]:
    """ChainAnteDecorators parity for the post chain: compose decorators
    in order into one callable."""

    def run(ctx: PostContext) -> None:
        for dec in decorators:
            dec(ctx)

    return run
