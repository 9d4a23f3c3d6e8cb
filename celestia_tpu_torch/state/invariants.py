"""x/crisis equivalent: registered state invariants, assertable on demand.

Parity role: the cosmos-sdk crisis keeper the reference wires at
app/app.go:196,312-315 (CrisisKeeper + each module's
RegisterInvariants).  An invariant breach on a live chain is a
halt-the-world event; here `assert_invariants` raises InvariantBroken and
the node surfaces it.  MsgVerifyInvariant lets anyone force a check
on-chain (the SDK pays a constant fee for it; we charge gas).

The registered set mirrors the module invariants the reference's app
actually registers: bank total-supply, staking bonded-pool backing, and
distribution module-account solvency.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

GAS_COST_PER_INVARIANT = 100_000


class InvariantBroken(RuntimeError):
    pass


def bank_total_supply(app) -> Tuple[bool, str]:
    """Sum of all native-denom balances == recorded supply."""
    total = sum(app.bank.all_balances().values())
    supply = app.bank.supply()
    if total != supply:
        return False, f"sum(balances) {total} != supply {supply}"
    return True, ""


def staking_bonded_pool(app) -> Tuple[bool, str]:
    """Every validator's bonded tokens are backed 1:1 by the bonded pool
    module account."""
    from celestia_tpu_torch.state.bank import BONDED_POOL

    bonded = sum(v.tokens for v in app.staking.validators())
    pool = app.bank.balance(BONDED_POOL)
    if bonded != pool:
        return False, f"validator tokens {bonded} != bonded pool {pool}"
    return True, ""


def distribution_solvency(app) -> Tuple[bool, str]:
    """The distribution module account covers the community pool and all
    accrued commission (outstanding delegator rewards ride the same
    account; solvency requires balance >= known liabilities)."""
    from celestia_tpu_torch.state.modules.distribution import (
        _COMMISSION_PREFIX,
        DISTRIBUTION_MODULE,
    )

    liabilities = app.distribution.community_pool()
    for _, raw in app.distribution.store.iterate(_COMMISSION_PREFIX):
        liabilities += int.from_bytes(raw, "big")
    balance = app.bank.balance(DISTRIBUTION_MODULE)
    if balance < liabilities:
        return False, (
            f"distribution account {balance} < community pool + commission "
            f"{liabilities}"
        )
    return True, ""


def gov_deposits_escrowed(app) -> Tuple[bool, str]:
    """Proposals still in voting keep their deposits escrowed in the gov
    pool (refunded on resolution, burned on veto)."""
    from celestia_tpu_torch.state.modules.gov import (
        GOV_MODULE_ADDR,
        PROPOSAL_STATUS_VOTING,
    )

    total = sum(
        p.deposit
        for p in app.gov.proposals()
        if p.status == PROPOSAL_STATUS_VOTING
    )
    balance = app.bank.balance(GOV_MODULE_ADDR)
    if balance < total:
        return False, f"gov escrow {balance} < active deposits {total}"
    return True, ""


DEFAULT_INVARIANTS: Dict[str, Callable] = {
    "bank/total-supply": bank_total_supply,
    "staking/bonded-pool": staking_bonded_pool,
    "distribution/solvency": distribution_solvency,
    "gov/deposits": gov_deposits_escrowed,
}


def assert_invariants(app, names: List[str] = None) -> Dict[str, str]:
    """Run all (or the named) registered invariants; raise InvariantBroken
    on the first failure.  Returns {name: 'ok'} on success.  An unknown
    name is an error — silently checking nothing would report success for
    a check that never ran (the SDK errors on unknown routes too)."""
    if names:
        unknown = [n for n in names if n not in DEFAULT_INVARIANTS]
        if unknown:
            raise ValueError(f"unknown invariant route(s): {unknown}")
    results: Dict[str, str] = {}
    for name, fn in DEFAULT_INVARIANTS.items():
        if names and name not in names:
            continue
        ok, msg = fn(app)
        if not ok:
            raise InvariantBroken(f"invariant {name} broken: {msg}")
        results[name] = "ok"
    return results
