"""Layered node configuration: defaults < config.toml < env < flags.

Parity role: the reference's cobra/viper layering with the CELESTIA env
prefix (cmd/celestia-appd/cmd/root.go:44-113) over celestia-flavoured
default comet/app configs (app/default_overrides.go:217-300).  The same
precedence order is implemented here with stdlib tomllib; env vars use the
``CELESTIA_`` prefix with ``__`` as the section separator
(e.g. ``CELESTIA_MEMPOOL__TTL_BLOCKS=10``).
"""

from __future__ import annotations

import json
import os
import time

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: the API-compatible backport
    import tomli as tomllib
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

ENV_PREFIX = "CELESTIA_"


@dataclass
class MempoolConfig:
    # prioritized mempool v1 with a 5-block TTL, MaxTxBytes from the max
    # square (default_overrides.go:258-284)
    ttl_blocks: int = 5
    max_tx_bytes: int = 128 * 128 * 482


@dataclass
class GrpcConfig:
    enable: bool = True
    address: str = "127.0.0.1:9090"


@dataclass
class SnapshotConfig:
    # state-sync snapshots every 1500 blocks, keep 2
    # (default_overrides.go:296-297)
    interval: int = 1500
    keep_recent: int = 2


@dataclass
class ConsensusConfig:
    # 15s goal block time (appconsts/consensus_consts.go:5-12)
    block_interval_s: float = 15.0
    create_empty_blocks: bool = True


@dataclass
class LogConfig:
    level: str = "info"
    format: str = "plain"  # plain | json
    to_file: str = ""


@dataclass
class NodeConfig:
    chain_id: str = "celestia-tpu-1"
    # 0.002utia floor (x/minfee, v2/app_consts.go:5-9)
    min_gas_price: float = 0.002
    v2_upgrade_height: Optional[int] = None
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    grpc: GrpcConfig = field(default_factory=GrpcConfig)
    snapshot: SnapshotConfig = field(default_factory=SnapshotConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    log: LogConfig = field(default_factory=LogConfig)

    def to_toml(self) -> str:
        lines = ["# celestia-tpu node configuration", ""]
        top, sections = {}, {}
        for key, val in asdict(self).items():
            if isinstance(val, dict):
                sections[key] = val
            else:
                top[key] = val
        for key, val in top.items():
            if val is None:
                continue
            lines.append(f"{key} = {_toml_value(val)}")
        for name, sec in sections.items():
            lines.append("")
            lines.append(f"[{name}]")
            for key, val in sec.items():
                if val is None:
                    continue
                lines.append(f"{key} = {_toml_value(val)}")
        return "\n".join(lines) + "\n"


def _toml_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    return json.dumps(str(v))


def _apply(cfg: NodeConfig, section: Optional[str], key: str, value: Any) -> None:
    target = getattr(cfg, section) if section else cfg
    if not hasattr(target, key):
        raise ValueError(
            f"unknown config key: {section + '.' if section else ''}{key}"
        )
    cur = getattr(target, key)
    if cur is not None and not isinstance(value, type(cur)):
        # coerce strings from env vars to the field's type
        if isinstance(cur, bool):
            value = str(value).lower() in ("1", "true", "yes", "on")
        elif isinstance(cur, int):
            value = int(value)
        elif isinstance(cur, float):
            value = float(value)
        else:
            value = str(value)
    setattr(target, key, value)


def load_config(
    home: Optional[str] = None,
    env: Optional[Dict[str, str]] = None,
    overrides: Optional[Dict[str, Any]] = None,
) -> NodeConfig:
    """Resolve config with precedence: defaults < file < env < overrides."""
    cfg = NodeConfig()
    if home:
        path = Path(home) / "config" / "config.toml"
        if path.exists():
            with open(path, "rb") as f:
                data = tomllib.load(f)
            for key, val in data.items():
                if isinstance(val, dict):
                    for k2, v2 in val.items():
                        _apply(cfg, key, k2, v2)
                else:
                    _apply(cfg, None, key, val)
    for name, val in (env if env is not None else os.environ).items():
        if not name.startswith(ENV_PREFIX):
            continue
        spec = name[len(ENV_PREFIX):].lower()
        if "__" in spec:
            section, key = spec.split("__", 1)
            try:
                _apply(cfg, section, key, val)
            except (AttributeError, ValueError):
                continue  # unrelated CELESTIA_* env var
        else:
            try:
                _apply(cfg, None, spec, val)
            except ValueError:
                continue
    for spec, val in (overrides or {}).items():
        if "." in spec:
            section, key = spec.split(".", 1)
            _apply(cfg, section, key, val)
        else:
            _apply(cfg, None, spec, val)
    return cfg


def init_home(
    home: str,
    chain_id: str = "celestia-tpu-1",
    overwrite: bool = False,
    extra_accounts: Optional[list] = None,  # [(address_bytes, balance)]
) -> Path:
    """``celestia-tpu init`` — create home layout: config + genesis + keys.

    Mirrors the reference's init command output (config/, data/ dirs,
    genesis.json, node key) at cmd/celestia-appd/cmd/root.go:126-161.
    """
    root = Path(home)
    cfg_dir = root / "config"
    data_dir = root / "data"
    if cfg_dir.exists() and not overwrite:
        if (cfg_dir / "genesis.json").exists():
            raise FileExistsError(f"{home} is already initialised")
    cfg_dir.mkdir(parents=True, exist_ok=True)
    data_dir.mkdir(parents=True, exist_ok=True)
    cfg = NodeConfig(chain_id=chain_id)
    (cfg_dir / "config.toml").write_text(cfg.to_toml())

    from celestia_tpu_torch.utils.secp256k1 import PrivateKey

    val_key = PrivateKey.from_seed(os.urandom(32))
    (cfg_dir / "priv_validator_key.json").write_text(
        json.dumps({"priv_key": val_key.d.to_bytes(32, "big").hex()}, indent=1)
    )
    from celestia_tpu_torch.ops.gf256 import CODEC_LEOPARD

    val_addr = val_key.public_key().address()
    genesis = {
        "chain_id": chain_id,
        # a CONCRETE genesis time, pinned at init: 0 means "unset" to the
        # node (it would substitute per-node wall clock — diverging app
        # hashes across a shared-genesis ceremony)
        "genesis_time_ns": time.time_ns(),
        # the codec is written EXPLICITLY so "no codec key" always means
        # a pre-ADR-012 file (migrate-genesis pins those to lagrange);
        # leaving it implicit would make that inference ambiguous
        "codec": CODEC_LEOPARD,
        "accounts": [
            {"address": val_addr.hex(), "balance": 1_000_000_000_000}
        ]
        + [
            {"address": addr.hex(), "balance": balance}
            for addr, balance in (extra_accounts or [])
        ],
        "validators": [
            {"address": val_addr.hex(), "self_delegation": 100_000_000_000}
        ],
    }
    (cfg_dir / "genesis.json").write_text(json.dumps(genesis, indent=1))
    return root
