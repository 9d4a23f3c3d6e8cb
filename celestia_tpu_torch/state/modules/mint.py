"""x/mint: time-based (not block-based) inflation.

Parity with x/mint/: BeginBlocker (abci.go:14-20),
CalculateInflationRate (types/minter.go:43-52, 8% initial, -10%/yr decay,
1.5% floor), CalculateBlockProvision (types/minter.go:56-65, proportional to
wall-clock elapsed since the previous block), constants
(types/constants.go).

All arithmetic is integer fixed-point (ppm for rates, nanoseconds for time)
so every validator computes identical provisions — the decimal-determinism
requirement the reference gets from sdk.Dec.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from celestia_tpu_torch.da.shares import _read_varint, _varint
from celestia_tpu_torch.state.bank import FEE_COLLECTOR, BankKeeper
from celestia_tpu_torch.state.store import KVStore

INITIAL_INFLATION_PPM = 80_000  # 8.00%
DISINFLATION_RATE_PCT = 10  # -10% per year
TARGET_INFLATION_PPM = 15_000  # 1.50% floor
NANOSECONDS_PER_YEAR = 365_2425 * 24 * 60 * 60 * 10**9 // 10_000  # 365.2425 d

_STATE_KEY = b"minter"


def inflation_rate_ppm(years_since_genesis: int) -> int:
    """max(8% * 0.9^years, 1.5%) in parts-per-million (minter.go:43-52)."""
    if years_since_genesis < 0:
        years_since_genesis = 0
    num = INITIAL_INFLATION_PPM * (100 - DISINFLATION_RATE_PCT) ** years_since_genesis
    den = 100**years_since_genesis
    rate = num // den
    return max(rate, TARGET_INFLATION_PPM)


@dataclass
class MinterState:
    genesis_time_ns: int
    previous_block_time_ns: int
    inflation_ppm: int = INITIAL_INFLATION_PPM
    annual_provisions: int = 0  # utia/year

    def marshal(self) -> bytes:
        out = bytearray()
        for v in (
            self.genesis_time_ns,
            self.previous_block_time_ns,
            self.inflation_ppm,
            self.annual_provisions,
        ):
            out += _varint(v)
        return bytes(out)

    @classmethod
    def unmarshal(cls, raw: bytes) -> "MinterState":
        vals = []
        pos = 0
        for _ in range(4):
            v, pos = _read_varint(raw, pos)
            vals.append(v)
        return cls(*vals)


class MintKeeper:
    def __init__(self, store: KVStore, bank: BankKeeper):
        self.store = store
        self.bank = bank

    def state(self) -> Optional[MinterState]:
        raw = self.store.get(_STATE_KEY)
        return MinterState.unmarshal(raw) if raw else None

    def set_state(self, s: MinterState) -> None:
        self.store.set(_STATE_KEY, s.marshal())

    def init_genesis(self, genesis_time_ns: int) -> None:
        self.set_state(MinterState(genesis_time_ns, genesis_time_ns))

    def begin_blocker(self, block_time_ns: int) -> int:
        """Mint the block provision to the fee collector; returns utia minted
        (x/mint/abci.go:14-20)."""
        s = self.state()
        if s is None:
            raise RuntimeError("mint module not initialized at genesis")
        years = (block_time_ns - s.genesis_time_ns) // NANOSECONDS_PER_YEAR
        s.inflation_ppm = inflation_rate_ppm(years)
        s.annual_provisions = self.bank.supply() * s.inflation_ppm // 1_000_000
        elapsed_ns = max(block_time_ns - s.previous_block_time_ns, 0)
        provision = s.annual_provisions * elapsed_ns // NANOSECONDS_PER_YEAR
        if provision > 0:
            self.bank.mint(FEE_COLLECTOR, provision)
        s.previous_block_time_ns = block_time_ns
        self.set_state(s)
        return provision
