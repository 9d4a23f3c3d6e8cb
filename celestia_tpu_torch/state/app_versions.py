"""Versioned module manager (ADR-022 / app/module parity).

The reference registers each module with a [FromVersion, ToVersion] range in
the manager (app/module/module.go:20-100 NewManager + VersionedModule), a
versioned configurator records which messages each app version accepts
(configurator.go:34-76, consumed by the ante MsgVersioningGateKeeper), and
RunMigrations (module.go:231) walks registered per-module migrations on
upgrade.  This file implements the same structure: modules declare their
version range, owned message types and migrations; everything else —
accepted-message sets, supported versions, migration plans — is DERIVED
from the module registry rather than hand-kept tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from celestia_tpu_torch.appconsts import V1_VERSION, V2_VERSION
from celestia_tpu_torch.state.tx import (
    MsgAuthzGrant,
    MsgAuthzRevoke,
    MsgCreateVestingAccount,
    MsgDelegate,
    MsgExec,
    MsgFundCommunityPool,
    MsgGrantAllowance,
    MsgParamChange,
    MsgPayForBlobs,
    MsgRegisterEVMAddress,
    MsgRevokeAllowance,
    MsgSend,
    MsgSetWithdrawAddress,
    MsgSignalVersion,
    MsgSubmitEvidence,
    MsgSubmitProposal,
    MsgTryUpgrade,
    MsgUndelegate,
    MsgUnjail,
    MsgVerifyInvariant,
    MsgVote,
    MsgWithdrawDelegatorReward,
    MsgWithdrawValidatorCommission,
)

INF_VERSION = 1 << 30  # "open-ended" ToVersion


@dataclass(frozen=True)
class VersionedModule:
    """One module registration (module.go VersionedModule parity)."""

    name: str
    from_version: int
    to_version: int = INF_VERSION
    msg_types: Tuple[type, ...] = ()
    # target_version -> migration(app); run when upgrading TO that version
    migrations: Tuple[Tuple[int, Callable], ...] = ()

    def active_at(self, version: int) -> bool:
        return self.from_version <= version <= self.to_version


class Manager:
    """The versioned module manager (app/module/module.go Manager)."""

    def __init__(self, modules: Sequence[VersionedModule] = ()):
        self._modules: List[VersionedModule] = []
        # version -> accepted msg-type frozenset; the gatekeeper asks
        # once per tx, so this is recomputed only when the module set
        # changes (frozen: the cached object is handed out directly)
        self._accept_cache: Dict[int, frozenset] = {}
        for m in modules:
            self.register(m)

    def register(self, module: VersionedModule) -> None:
        if module.from_version > module.to_version:
            raise ValueError(
                f"module {module.name}: FromVersion {module.from_version} > "
                f"ToVersion {module.to_version}"
            )
        for existing in self._modules:
            if existing.name == module.name and not (
                module.to_version < existing.from_version
                or module.from_version > existing.to_version
            ):
                raise ValueError(
                    f"module {module.name}: overlapping version ranges"
                )
        self._modules.append(module)
        self._accept_cache.clear()

    def unregister(self, name: str, from_version: Optional[int] = None) -> None:
        self._modules = [
            m
            for m in self._modules
            if not (
                m.name == name
                and (from_version is None or m.from_version == from_version)
            )
        ]
        self._accept_cache.clear()

    def modules_at(self, version: int) -> List[VersionedModule]:
        return [m for m in self._modules if m.active_at(version)]

    def supported_versions(self) -> List[int]:
        """Every version in some module's range, bounded by declared
        endpoints (a version is supported iff at least one module declared
        it explicitly as a From bound or it sits inside all ranges)."""
        bounds: Set[int] = set()
        for m in self._modules:
            bounds.add(m.from_version)
            if m.to_version != INF_VERSION:
                bounds.add(m.to_version)
        return sorted(v for v in bounds if self.modules_at(v))

    def msgs_accepted_at(self, version: int) -> frozenset:
        cached = self._accept_cache.get(version)
        if cached is not None:
            return cached
        active = self.modules_at(version)
        if version not in self.supported_versions():
            raise ValueError(f"unsupported app version {version}")
        out: Set[type] = set()
        for m in active:
            out.update(m.msg_types)
        frozen = frozenset(out)
        self._accept_cache[version] = frozen
        return frozen

    def run_migrations(self, app, from_version: int, to_version: int) -> List[str]:
        """RunMigrations parity (module.go:231): step through every version
        between (from, to], applying each active module's migrations
        registered for that target version, in registration order."""
        log: List[str] = []
        for v in range(from_version + 1, to_version + 1):
            for m in self._modules:
                if not m.active_at(v):
                    continue
                for target, fn in m.migrations:
                    if target == v:
                        fn(app)
                        log.append(f"{m.name}: {fn.__name__} -> v{v}")
        return log


# ---------------------------------------------------------------------------
# the default registry — mirrors app/app.go:435-528 module wiring
# ---------------------------------------------------------------------------


def _migrate_v2_minfee(app) -> None:
    """v1 -> v2: introduce the x/minfee network min gas price param."""
    from celestia_tpu_torch.appconsts import GLOBAL_MIN_GAS_PRICE_PPM

    if not app.params.has("minfee", "NetworkMinGasPricePpm"):
        app.params.set("minfee", "NetworkMinGasPricePpm", GLOBAL_MIN_GAS_PRICE_PPM)


DEFAULT_MODULES: Tuple[VersionedModule, ...] = (
    VersionedModule("bank", V1_VERSION, msg_types=(MsgSend,)),
    VersionedModule("blob", V1_VERSION, msg_types=(MsgPayForBlobs,)),
    VersionedModule(
        "staking", V1_VERSION, msg_types=(MsgDelegate, MsgUndelegate)
    ),
    VersionedModule(
        "blobstream", V1_VERSION, msg_types=(MsgRegisterEVMAddress,)
    ),
    VersionedModule("params", V1_VERSION, msg_types=(MsgParamChange,)),
    VersionedModule(
        "gov", V1_VERSION, msg_types=(MsgSubmitProposal, MsgVote)
    ),
    VersionedModule("mint", V1_VERSION),
    VersionedModule("paramfilter", V1_VERSION),
    VersionedModule("tokenfilter", V1_VERSION),
    VersionedModule(
        "feegrant",
        V1_VERSION,
        msg_types=(MsgGrantAllowance, MsgRevokeAllowance),
    ),
    VersionedModule(
        "authz",
        V1_VERSION,
        msg_types=(MsgAuthzGrant, MsgAuthzRevoke, MsgExec),
    ),
    VersionedModule(
        "distribution",
        V1_VERSION,
        msg_types=(
            MsgWithdrawDelegatorReward,
            MsgWithdrawValidatorCommission,
            MsgFundCommunityPool,
            MsgSetWithdrawAddress,
        ),
    ),
    VersionedModule("slashing", V1_VERSION, msg_types=(MsgUnjail,)),
    VersionedModule("evidence", V1_VERSION, msg_types=(MsgSubmitEvidence,)),
    VersionedModule("crisis", V1_VERSION, msg_types=(MsgVerifyInvariant,)),
    VersionedModule(
        "vesting", V1_VERSION, msg_types=(MsgCreateVestingAccount,)
    ),
    # x/upgrade signalling arrives in v2 (ADR-018); x/minfee's param
    # subspace is created by its v2 migration
    VersionedModule(
        "upgrade",
        V2_VERSION,
        msg_types=(MsgSignalVersion, MsgTryUpgrade),
    ),
    VersionedModule(
        "minfee", V2_VERSION, migrations=((V2_VERSION, _migrate_v2_minfee),)
    ),
)

MANAGER = Manager(DEFAULT_MODULES)


# ---------------------------------------------------------------------------
# module-level convenience API (used by App + ante gatekeeper)
# ---------------------------------------------------------------------------


def msgs_accepted_at(app_version: int) -> Set[type]:
    return MANAGER.msgs_accepted_at(app_version)


def supported_versions() -> List[int]:
    return MANAGER.supported_versions()


def run_migrations(app, from_version: int, to_version: int) -> List[str]:
    return MANAGER.run_migrations(app, from_version, to_version)


def register_version(version: int, msgs: Set[type]) -> None:
    """Register a future app version (what a new binary release does): a
    synthetic module carrying that version's new message set."""
    MANAGER.register(
        VersionedModule(
            f"release-v{version}", version, msg_types=tuple(msgs)
        )
    )


def unregister_version(version: int) -> None:
    MANAGER.unregister(f"release-v{version}")


def register_migration(target_version: int, fn: Callable) -> None:
    """Attach a standalone migration (testing hook)."""
    MANAGER.register(
        VersionedModule(
            f"migration-{fn.__name__}-v{target_version}",
            target_version,
            migrations=((target_version, fn),),
        )
    )
