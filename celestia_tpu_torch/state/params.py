"""Parameter store with subspaces + the hardfork-param governance blocklist.

Parity role: cosmos params subspaces as used by every module, plus
x/paramfilter's ParamBlockList (gov_handler.go:36-60) enforcing that
hardfork-only parameters (the list at app/app.go:856-867)
cannot be changed by governance.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

from celestia_tpu_torch.appconsts import (
    DEFAULT_GAS_PER_BLOB_BYTE,
    DEFAULT_GOV_MAX_SQUARE_SIZE,
    DEFAULT_UNBONDING_TIME_SECONDS,
    GLOBAL_MIN_GAS_PRICE_PPM,
)
from celestia_tpu_torch.state.store import KVStore


_ABSENT = object()  # memoized "key not in store" (distinct from stored null)


class ParamsKeeper:
    def __init__(self, store: KVStore):
        self.store = store
        # read-through memo: the ante chain reads the same few params for
        # every tx in a proposal; decode each once per keeper instance.
        # Writes go through set() (which invalidates), and every branch
        # swap builds a fresh keeper, so the memo cannot go stale.
        self._memo: Dict[Tuple[str, str], Any] = {}

    def _key(self, subspace: str, key: str) -> bytes:
        return f"{subspace}/{key}".encode()

    def set(self, subspace: str, key: str, value: Any) -> None:
        self.store.set(self._key(subspace, key), json.dumps(value).encode())
        self._memo.pop((subspace, key), None)

    def get(self, subspace: str, key: str, default: Any = None) -> Any:
        mk = (subspace, key)
        if mk in self._memo:
            val = self._memo[mk]
        else:
            raw = self.store.get(self._key(subspace, key))
            val = _ABSENT if raw is None else json.loads(raw.decode())
            self._memo[mk] = val
        if val is _ABSENT:
            return default
        if isinstance(val, (list, dict)):
            # callers may mutate their copy; the memo (and therefore
            # later reads) must keep matching the committed store
            return json.loads(json.dumps(val))
        return val

    def has(self, subspace: str, key: str) -> bool:
        return self.store.has(self._key(subspace, key))

    def all_params(self) -> Dict[str, Any]:
        return {k.decode(): json.loads(v.decode()) for k, v in self.store.iterate()}


# (subspace, key) pairs changeable only via hardfork — app.go:856-867 parity.
BLOCKED_PARAMS: Tuple[Tuple[str, str], ...] = (
    ("bank", "SendEnabled"),
    ("staking", "BondDenom"),
    ("staking", "MaxValidators"),
    ("staking", "UnbondingTime"),
    ("consensus", "ValidatorPubKeyTypes"),
)


class ParamBlockList:
    """x/paramfilter: rejects governance changes to blocked params."""

    def __init__(self, blocked: Tuple[Tuple[str, str], ...] = BLOCKED_PARAMS):
        self.blocked = set(blocked)

    def is_blocked(self, subspace: str, key: str) -> bool:
        return (subspace, key) in self.blocked

    def validate_change(self, subspace: str, key: str) -> None:
        if self.is_blocked(subspace, key):
            raise ValueError(
                f"parameter {subspace}/{key} can only be changed via hardfork"
            )


def set_default_params(params: ParamsKeeper) -> None:
    """Genesis defaults (initial_consts.go:8-31, v2/app_consts.go:5-9,
    x/blob params at x/blob keeper defaults)."""
    params.set("blob", "GasPerBlobByte", DEFAULT_GAS_PER_BLOB_BYTE)
    params.set("blob", "GovMaxSquareSize", DEFAULT_GOV_MAX_SQUARE_SIZE)
    params.set("minfee", "NetworkMinGasPricePpm", GLOBAL_MIN_GAS_PRICE_PPM)
    params.set("staking", "BondDenom", "utia")
    params.set("staking", "UnbondingTime", DEFAULT_UNBONDING_TIME_SECONDS)
    params.set("staking", "MaxValidators", 100)
    params.set("bank", "SendEnabled", True)
    params.set("consensus", "ValidatorPubKeyTypes", ["secp256k1"])
    params.set("blobstream", "DataCommitmentWindow", 400)
