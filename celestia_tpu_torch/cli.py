"""celestia-tpu — the node daemon + client command tree.

Parity with the reference CLI (cmd/celestia-appd/cmd/root.go:55-161):
``init``, ``start``, ``keys``, ``tx`` (bank send / blob pay-for-blob),
``query`` (balance / tx / block / status / proof), ``status``, plus the
``blocktime`` tool (tools/blocktime/main.go:20-96).

Run as ``python -m celestia_tpu_torch.cli <command>`` or via the celestia-tpu
entry point.  The ``start`` command serves the gRPC node service
(node/server.py) that every client command talks to over the network.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from pathlib import Path

DEFAULT_HOME = os.path.expanduser("~/.celestia-tpu")


def _home(args) -> str:
    return args.home or os.environ.get("CELESTIA_HOME", DEFAULT_HOME)


# ---------------------------------------------------------------------------
# keyring (file-backed, seed keys)
# ---------------------------------------------------------------------------


def _keyring_dir(home: str) -> Path:
    d = Path(home) / "keyring"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _load_key(home: str, name: str):
    from celestia_tpu_torch.utils.secp256k1 import PrivateKey

    path = _keyring_dir(home) / f"{name}.json"
    if not path.exists():
        raise SystemExit(f"key {name!r} not found in {path.parent}")
    info = json.loads(path.read_text())
    return PrivateKey(int(info["priv"], 16))


def cmd_keys(args) -> int:
    from celestia_tpu_torch.utils.secp256k1 import PrivateKey

    home = _home(args)
    kd = _keyring_dir(home)
    if args.keys_cmd == "add":
        path = kd / f"{args.name}.json"
        if path.exists():
            raise SystemExit(f"key {args.name!r} already exists")
        key = PrivateKey.from_seed(os.urandom(32))
        addr = key.public_key().address()
        path.write_text(
            json.dumps({"priv": f"{key.d:064x}", "address": addr.hex()})
        )
        print(json.dumps({"name": args.name, "address": addr.hex()}))
    elif args.keys_cmd == "list":
        for p in sorted(kd.glob("*.json")):
            info = json.loads(p.read_text())
            print(json.dumps({"name": p.stem, "address": info["address"]}))
    elif args.keys_cmd == "show":
        key = _load_key(home, args.name)
        print(
            json.dumps(
                {
                    "name": args.name,
                    "address": key.public_key().address().hex(),
                    "pubkey": key.public_key().compressed().hex(),
                }
            )
        )
    return 0


# ---------------------------------------------------------------------------
# init / start
# ---------------------------------------------------------------------------


def cmd_init(args) -> int:
    from celestia_tpu_torch.node.config import init_home

    home = _home(args)
    if args.genesis and args.fund_keyring:
        raise SystemExit(
            "--fund-keyring conflicts with --genesis: a shared genesis "
            "replaces the generated one; add the accounts to the shared "
            "genesis file instead"
        )
    extra = []
    if args.fund_keyring:
        for p in sorted(_keyring_dir(home).glob("*.json")):
            info = json.loads(p.read_text())
            extra.append((bytes.fromhex(info["address"]), args.fund_keyring))
    root = init_home(
        home, chain_id=args.chain_id, overwrite=args.overwrite,
        extra_accounts=extra,
    )
    chain_id = args.chain_id
    if args.genesis:
        shared = json.loads(Path(args.genesis).read_text())
        chain_id = shared.get("chain_id", chain_id)
        (root / "config" / "genesis.json").write_text(
            json.dumps(shared, indent=1)
        )
    print(
        json.dumps(
            {
                "home": str(root),
                "chain_id": chain_id,
                "funded_accounts": len(extra),
            }
        )
    )
    return 0


def apply_host_thread_budget() -> int:
    """One host thread budget for a node on the CPU: the native pool
    (``hostpool.cpu_threads``: ``--cpu-threads``,
    ``CELESTIA_TPU_TORCH_CPU_THREADS``, else every core) and torch's
    intra-op threads, so that several nodes on one host can split its
    cores.  Returns the budget."""
    import torch

    from celestia_tpu_torch.utils import hostpool

    n = hostpool.cpu_threads()
    torch.set_num_threads(n)
    return n


def cmd_start(args) -> int:
    # the node's device: CELESTIA_TPU_TORCH_DEVICE (e.g. "cpu", the host
    # regime of da/dah.py that the tests run), else the card; without a
    # card the start fails at once (no wait for a backend, no CPU fallback)
    from celestia_tpu_torch.utils.device import resolve_device

    requested = os.environ.get("CELESTIA_TPU_TORCH_DEVICE", "").strip() or None
    try:
        device = resolve_device(requested)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(
            f"start: no usable device ({e}); a node without a CUDA card runs "
            "only with CELESTIA_TPU_TORCH_DEVICE=cpu"
        )

    if device.type == "cpu":
        apply_host_thread_budget()

    from celestia_tpu_torch.node.config import load_config
    from celestia_tpu_torch.node.server import NodeServer
    from celestia_tpu_torch.node.testnode import TestNode
    from celestia_tpu_torch.utils.logging import Logger
    from celestia_tpu_torch.utils.secp256k1 import PrivateKey

    home = _home(args)
    overrides = {}
    if args.grpc_address:
        overrides["grpc.address"] = args.grpc_address
    if args.block_interval is not None:
        overrides["consensus.block_interval_s"] = args.block_interval
    if args.v2_upgrade_height is not None:
        overrides["v2_upgrade_height"] = args.v2_upgrade_height
    cfg = load_config(home, overrides=overrides)
    log = Logger(level=cfg.log.level, fmt=cfg.log.format, to_file=cfg.log.to_file)

    trace_blocks = getattr(args, "trace_blocks", None)
    if getattr(args, "trace", False) or trace_blocks is not None:
        # block-lifecycle span tracing (utils/tracing.py): ring-buffered
        # last-N-blocks, served over the TraceDump RPC; near-zero
        # overhead would still argue for off-by-default — this is the
        # operator's explicit opt-in (CELESTIA_TPU_TORCH_TRACE works too).
        # --trace-blocks alone implies --trace: sizing a ring you did
        # not turn on would otherwise be a silent no-op.
        from celestia_tpu_torch.utils import tracing

        tracing.enable(trace_blocks)
        log.info("block tracing enabled", blocks=tracing.TRACER.max_blocks)

    if getattr(args, "mesh", None) is not None:
        # multi-chip mesh override (parallel/mesh.py): validated HERE so
        # a malformed spec fails the start loudly instead of poisoning
        # the mesh at the first block
        from celestia_tpu_torch.parallel import mesh as mesh_mod

        try:
            mesh_mod.configure(args.mesh)
        except ValueError as e:
            raise SystemExit(f"--mesh: {e}")

    genesis_path = Path(home) / "config" / "genesis.json"
    if not genesis_path.exists():
        raise SystemExit(f"no genesis at {genesis_path}; run `init` first")
    genesis = json.loads(genesis_path.read_text())
    key_path = Path(home) / "config" / "priv_validator_key.json"
    validator_key = None
    if key_path.exists():
        validator_key = PrivateKey(
            int(json.loads(key_path.read_text())["priv_key"], 16)
        )

    data_dir = str(Path(home) / "data")
    snapshot_dir = str(Path(home) / "data" / "snapshots")
    from celestia_tpu_torch.node.snapshots import SnapshotStore

    latest_snap = SnapshotStore(snapshot_dir).latest()
    blocks_log = Path(data_dir) / "blocks.log"
    node = None
    if blocks_log.exists() and blocks_log.stat().st_size > 0:
        # primary restart path: the append-only disk logs carry the whole
        # chain to the last fsynced block (app.go:657-661 LoadLatestVersion
        # role); snapshots below remain as the state-sync fallback
        node = TestNode(
            chain_id=genesis.get("chain_id", cfg.chain_id),
            genesis=genesis,
            validator_key=validator_key,
            block_interval_ns=int(cfg.consensus.block_interval_s * 1e9),
            auto_produce=False,
            min_gas_price=cfg.min_gas_price,
            v2_upgrade_height=cfg.v2_upgrade_height,
            snapshot_dir=snapshot_dir,
            snapshot_interval=cfg.snapshot.interval,
            snapshot_keep_recent=cfg.snapshot.keep_recent,
            data_dir=data_dir,
            device=device,
        )
        if node.blocks:
            log.info(
                "recovered chain from disk",
                height=node.height,
                app_hash=node.app.store.committed_hash(node.height).hex()[:16],
            )
        elif latest_snap is not None:
            # the block log was fully torn; the snapshot is newer than a
            # genesis reset, so prefer it.  The throwaway node has already
            # wiped + reopened the logs and seeded genesis STATE records —
            # release its file handles and clear those records so the
            # snapshot node reopens a clean data dir (no stale
            # pre-checkpoint genesis state, no leaked fds)
            node.close()
            for name in ("state.log", "blocks.log"):
                p = Path(data_dir) / name
                if p.exists():
                    p.unlink()
            node = None
        else:
            log.info("block log unreadable; restarted from genesis")
    if node is not None:
        pass
    elif latest_snap is not None:
        # restart path: resume from the latest state-sync snapshot instead
        # of silently resetting to genesis (root.go:227-243 restore wiring)
        node = TestNode.from_snapshot(
            snapshot_dir,
            block_interval_ns=int(cfg.consensus.block_interval_s * 1e9),
            auto_produce=False,
            snapshot_interval=cfg.snapshot.interval,
            snapshot_keep_recent=cfg.snapshot.keep_recent,
            validator_key=validator_key,
            min_gas_price=cfg.min_gas_price,
            v2_upgrade_height=cfg.v2_upgrade_height,
            data_dir=data_dir,
            device=device,
        )
        log.info(
            "restored from snapshot",
            height=latest_snap.height,
            app_hash=latest_snap.app_hash.hex()[:16],
        )
    else:
        node = TestNode(
            chain_id=genesis.get("chain_id", cfg.chain_id),
            genesis=genesis,
            validator_key=validator_key,
            block_interval_ns=int(cfg.consensus.block_interval_s * 1e9),
            auto_produce=False,
            min_gas_price=cfg.min_gas_price,
            v2_upgrade_height=cfg.v2_upgrade_height,
            snapshot_dir=snapshot_dir,
            snapshot_interval=cfg.snapshot.interval,
            snapshot_keep_recent=cfg.snapshot.keep_recent,
            data_dir=data_dir,
            device=device,
        )
    if node.genesis_doc is None:
        # recovery / snapshot-restore paths skip InitChain, but the home
        # still has the genesis file — keep serving it to joining peers
        node.genesis_doc = genesis
    if getattr(args, "bft_valset", None):
        # two-phase BFT mode: this node votes with its own key and
        # commits only on a 2/3 precommit quorum it verified itself
        valset = json.loads(Path(args.bft_valset).read_text())
        node.enable_bft(valset)
        log.info("BFT consensus enabled", validators=len(valset))
    # Pre-warm the extension BEFORE serving: the block producer holds the
    # service lock across the first extension of each square size, and the
    # kernel library's first build and load (nvcc at first use) there
    # would stall every RPC past its deadline.  Sizes are configurable;
    # warming at boot trades startup seconds for never stalling a live
    # block.
    raw_sizes = str(getattr(args, "warm_squares", "1,2,4"))
    try:
        warm_sizes = [int(s) for s in raw_sizes.split(",") if s.strip()]
    except ValueError:
        raise SystemExit(f"--warm-squares must be comma-separated ints: {raw_sizes!r}")
    for s in warm_sizes:
        if not 1 <= s <= 128 or s & (s - 1):
            raise SystemExit(
                f"--warm-squares sizes must be powers of two in [1, 128], got {s}"
            )
    if warm_sizes:
        import numpy as _np

        from celestia_tpu_torch.da import dah as _dah

        t_warm = time.time()
        for s in warm_sizes:
            _dah.extend_and_header(
                _np.zeros((s, s, 512), dtype=_np.uint8), device=device
            )
        log.info(
            "device programs warmed",
            sizes=",".join(map(str, warm_sizes)),
            seconds=round(time.time() - t_warm, 1),
        )
        # the warm-up already initialized the backend, so resolving the
        # mesh here is free — the operator sees at boot whether live
        # extends will shard (lazy resolution at the first block is the
        # fallback when warm-up was skipped)
        from celestia_tpu_torch.parallel import mesh as mesh_mod

        if mesh_mod.device_mesh() is not None:
            shape = mesh_mod.mesh_shape()
            log.info(
                "multi-chip mesh active",
                data=shape[0], row=shape[1],
            )
            # warm the SHARDED programs too: the live path routes
            # through them on a mesh-active node, so without this the
            # first real block would pay the structure-bound shard_map
            # compile in the hot path — exactly the stall --warm-squares
            # exists to prevent
            from celestia_tpu_torch.parallel import sharded as _sharded

            t_warm = time.time()
            warmed_sharded = []
            # mesh-eligible subset of the warm sizes; when NONE is
            # eligible (default '1,2,4' vs a wide row axis — every size
            # falls back) warm the smallest eligible size instead, so at
            # least one sharded program + the collective machinery
            # compiles at boot rather than inside the first big block
            # (operators size --warm-squares up for full coverage)
            shard_sizes = [
                s for s in warm_sizes
                if mesh_mod.mesh_for_square(s, count_fallback=False)
                is not None
            ]
            if not shard_sizes:
                row = shape[1]
                if row <= 128:
                    shard_sizes = [row]
            # a failed sharded warm-up raises: the port's mesh has no
            # poison, and the same failure at a live block would raise
            for s in shard_sizes:
                m = mesh_mod.mesh_for_square(s, count_fallback=False)
                if m is None:
                    continue
                _sharded.extend_and_roots_sharded(
                    _np.zeros((s, s, 512), dtype=_np.uint8), m,
                    record_stats=False,
                )
                warmed_sharded.append(s)
            if warmed_sharded:
                log.info(
                    "sharded device programs warmed",
                    sizes=",".join(map(str, warmed_sharded)),
                    seconds=round(time.time() - t_warm, 1),
                )
    device_profile_dir = None
    # CELESTIA_TPU_TORCH_DEVICE_PROFILE is the env equivalent of the flag
    # (same contract as CELESTIA_TPU_TORCH_TRACE): the flag wins when both
    # are present; truthy values mean "capture into the default dir",
    # explicit falsy values ("0"/"false"/"no"/"off") mean OFF — an
    # operator overriding an orchestration template must not end up
    # capturing into a directory literally named ./0 — anything else
    # is the capture directory itself
    env_profile = os.environ.get("CELESTIA_TPU_TORCH_DEVICE_PROFILE", "").strip()
    flag_profile = getattr(args, "device_profile", None)
    if flag_profile is None and env_profile:
        low = env_profile.lower()
        if low in ("1", "true", "yes", "on"):
            flag_profile = ""
        elif low not in ("0", "false", "no", "off"):
            flag_profile = env_profile
    if flag_profile is not None:
        # optional torch.profiler capture (utils/devprof.py): CPU and CUDA
        # activity as a Chrome trace, next to the device track
        from celestia_tpu_torch.utils import devprof

        device_profile_dir = flag_profile or str(
            Path(home) / "data" / "device-profile"
        )
        devprof.start_profiler(device_profile_dir)
        log.info("device profiler capturing", dir=device_profile_dir)
    # --host-profile without a value (the -1 sentinel) means "the
    # default rate"; an EXPLICIT 0 means off — matching the sibling
    # --timeseries-interval convention, so a wrapper templating the
    # flag can disable profiling without dropping the flag entirely
    raw_hp = getattr(args, "host_profile", None)
    host_profile_hz = None
    if raw_hp is not None and raw_hp != 0:
        from celestia_tpu_torch.utils import hostprof

        host_profile_hz = raw_hp if raw_hp > 0 else hostprof.DEFAULT_HZ
    flight_dir = getattr(args, "flight_dir", None)
    server = NodeServer(
        node,
        address=cfg.grpc.address,
        # validator mode: an external driver paces consensus; no self-loop
        block_interval_s=(
            None
            if args.validator or getattr(args, "bft_valset", None)
            else cfg.consensus.block_interval_s
        ),
        # plain-HTTP /metrics for a stock Prometheus (off by default)
        metrics_port=getattr(args, "metrics_port", None),
        # continuous telemetry snapshots (0 disables the sampler)
        timeseries_interval_s=getattr(args, "timeseries_interval", 5.0),
        # continuous host profiling (utils/hostprof.py; off by default)
        host_profile_hz=host_profile_hz,
        # anomaly flight recorder (utils/flight.py; off by default)
        flight_dir=flight_dir,
    )
    server.start()
    if server.metrics_http is not None:
        log.info(
            "metrics HTTP endpoint", address=server.metrics_http.address
        )
    if host_profile_hz:
        from celestia_tpu_torch.utils import hostprof

        log.info("host profiler sampling", hz=hostprof.hz())
    if flight_dir:
        log.info("flight recorder armed", dir=flight_dir)
    gossip = None
    if getattr(args, "peers", None) and getattr(args, "bft_valset", None):
        # p2p mesh mode: flood consensus messages directly between
        # validators, run own round timers, gossip txs want/have — the
        # bft-relay becomes an optional observer (node/gossip.py)
        from celestia_tpu_torch.node.gossip import GossipEngine

        gossip = GossipEngine(
            node,
            [a for a in args.peers.split(",") if a],
            block_gap_s=cfg.consensus.block_interval_s,
            logger=log.with_fields(mod="gossip"),
            # a catch-up window the node cannot adopt, or a proposal it
            # cannot build, ends it, as a failed block does (exit 1)
            on_failure=server.fail,
        )
        gossip.start()
        log.info("gossip mesh enabled", peers=len(gossip.peer_addrs))
    log.info(
        "node started",
        chain_id=node.chain_id,
        grpc=server.address,
        block_interval_s=cfg.consensus.block_interval_s,
    )
    print(
        json.dumps(
            {
                "grpc": server.address,
                "chain_id": node.chain_id,
                **(
                    {"metrics_http": server.metrics_http.address}
                    if server.metrics_http is not None
                    else {}
                ),
            }
        ),
        flush=True,
    )
    # SIGTERM (a process manager's stop) takes Ctrl-C's shutdown path: the
    # server stops, a profiler capture is written, and the exit code is 0
    import signal

    def _terminate(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _terminate)
    try:
        # the serve command's idle park: all work happens on the server's
        # and gossip's threads; a failed block producer, catch-up or
        # proposal ends it with exit 1
        server.failed.wait()
        what = ", ".join(
            {"producer": "block producer", "catchup": "catch-up"}.get(w, w)
            for w in server.service.failures
        )
        log.error(
            f"{what} failed; shutting down", error=repr(server.failure)
        )
        if gossip is not None:
            gossip.stop()
        server.stop()
        return 1
    except KeyboardInterrupt:
        log.info("shutting down")
        if gossip is not None:
            gossip.stop()
        server.stop()
        if device_profile_dir is not None:
            from celestia_tpu_torch.utils import devprof

            stopped = devprof.stop_profiler()
            if stopped:
                log.info("device profiler capture written", dir=stopped)
    return 0


# ---------------------------------------------------------------------------
# tx / query (remote client commands)
# ---------------------------------------------------------------------------


def _remote(args):
    from celestia_tpu_torch.client.remote import RemoteNode

    return RemoteNode(args.node, timeout_s=getattr(args, "timeout", 120.0))


def cmd_tx(args) -> int:
    from celestia_tpu_torch.client.signer import Signer

    home = _home(args)
    node = _remote(args)
    key = _load_key(home, getattr(args, "from_key"))
    signer = Signer(node, key)
    if args.tx_cmd == "send":
        from celestia_tpu_torch.state.tx import MsgSend

        msg = MsgSend(
            from_addr=signer.address,
            to_addr=bytes.fromhex(args.to),
            amount=int(args.amount),
        )
        res = signer.submit_tx([msg])
    elif args.tx_cmd == "pay-for-blob":
        from celestia_tpu_torch.da.blob import Blob
        from celestia_tpu_torch.da.namespace import Namespace

        if args.data.startswith("@"):
            data = Path(args.data[1:]).read_bytes()
        else:
            data = bytes.fromhex(args.data)
        ns = Namespace.v0(bytes.fromhex(args.namespace))
        res = signer.submit_pay_for_blob([Blob(ns, data)])
    elif args.tx_cmd == "delegate":
        from celestia_tpu_torch.state.tx import MsgDelegate

        res = signer.submit_tx([
            MsgDelegate(
                signer.address, bytes.fromhex(args.validator),
                int(args.amount),
            )
        ])
    elif args.tx_cmd == "undelegate":
        from celestia_tpu_torch.state.tx import MsgUndelegate

        res = signer.submit_tx([
            MsgUndelegate(
                signer.address, bytes.fromhex(args.validator),
                int(args.amount),
            )
        ])
    elif args.tx_cmd == "withdraw-rewards":
        from celestia_tpu_torch.state.tx import MsgWithdrawDelegatorReward

        res = signer.submit_tx([
            MsgWithdrawDelegatorReward(
                signer.address, bytes.fromhex(args.validator)
            )
        ])
    elif args.tx_cmd == "withdraw-commission":
        from celestia_tpu_torch.state.tx import MsgWithdrawValidatorCommission

        res = signer.submit_tx([MsgWithdrawValidatorCommission(signer.address)])
    elif args.tx_cmd == "fund-community-pool":
        from celestia_tpu_torch.state.tx import MsgFundCommunityPool

        res = signer.submit_tx([
            MsgFundCommunityPool(signer.address, int(args.amount))
        ])
    elif args.tx_cmd == "grant-allowance":
        from celestia_tpu_torch.state.modules.feegrant import KIND_BASIC, KIND_PERIODIC
        from celestia_tpu_torch.state.tx import MsgGrantAllowance

        res = signer.submit_tx([
            MsgGrantAllowance(
                signer.address, bytes.fromhex(args.grantee),
                KIND_PERIODIC if args.period_ns else KIND_BASIC,
                int(args.spend_limit), int(args.expiration_ns),
                int(args.period_ns), int(args.period_spend_limit),
            )
        ])
    elif args.tx_cmd == "revoke-allowance":
        from celestia_tpu_torch.state.tx import MsgRevokeAllowance

        res = signer.submit_tx([
            MsgRevokeAllowance(signer.address, bytes.fromhex(args.grantee))
        ])
    elif args.tx_cmd == "authz-grant":
        from celestia_tpu_torch.state.tx import MsgAuthzGrant

        res = signer.submit_tx([
            MsgAuthzGrant(
                signer.address, bytes.fromhex(args.grantee),
                int(args.msg_type), int(args.spend_limit),
                int(args.expiration_ns),
            )
        ])
    elif args.tx_cmd == "unjail":
        from celestia_tpu_torch.state.tx import MsgUnjail

        res = signer.submit_tx([MsgUnjail(signer.address)])
    else:  # pragma: no cover
        raise SystemExit(f"unknown tx command {args.tx_cmd}")
    # submit_tx / submit_pay_for_blob broadcast AND poll-confirm; the
    # result carries the inclusion height
    out = {
        "code": res.code,
        "txhash": res.tx_hash.hex(),
        "log": res.log,
        "height": res.height,
    }
    print(json.dumps(out))
    return 0 if res.code == 0 else 1


def cmd_query(args) -> int:
    node = _remote(args)
    if args.query_cmd == "balance":
        value = node.abci_query("store/bank/balance", {"address": args.address})
        print(json.dumps({"address": args.address, "balance": value}))
    elif args.query_cmd == "account":
        value = node.abci_query("custom/auth/account", {"address": args.address})
        print(json.dumps(value))
    elif args.query_cmd == "tx":
        info = node.get_tx(bytes.fromhex(args.hash))
        print(json.dumps(info if info else {"found": False}))
    elif args.query_cmd == "txs":
        value = node.abci_query("custom/tx/search", {"event": args.event})
        print(json.dumps(value))
    elif args.query_cmd == "state-proof":
        # fetch + VERIFY a (store, key) membership proof against the
        # block header's app hash, like a light client would
        from celestia_tpu_torch.state.merkle import verify_query_proof

        data = {"store": args.store, "key": args.key}
        if args.height:
            data["height"] = args.height
        proof = node.abci_query("store/proof", data)
        trusted = bytes.fromhex(node.block(proof["height"])["app_hash"])
        ok = verify_query_proof(proof, trusted)
        print(json.dumps({"verified": ok, **proof}))
        if not ok:
            return 1
    elif args.query_cmd == "block":
        print(json.dumps(node.block(int(args.height))))
    elif args.query_cmd == "param":
        value = node.abci_query(
            "custom/params/param", {"subspace": args.subspace, "key": args.key}
        )
        print(json.dumps({"value": value}))
    elif args.query_cmd == "share-proof":
        value = node.abci_query(
            "custom/proof/share",
            {"height": args.height, "start": args.start, "end": args.end},
        )
        print(json.dumps(value))
    elif args.query_cmd == "tx-proof":
        value = node.abci_query(
            "custom/proof/tx", {"height": args.height, "tx_index": args.index}
        )
        print(json.dumps(value))
    elif args.query_cmd == "rewards":
        value = node.abci_query(
            "custom/distribution/rewards",
            {"delegator": args.delegator, "validator": args.validator},
        )
        print(json.dumps(value))
    elif args.query_cmd == "community-pool":
        print(json.dumps(node.abci_query(
            "custom/distribution/community-pool", {}
        )))
    elif args.query_cmd == "signing-info":
        print(json.dumps(node.abci_query(
            "custom/slashing/signing-info", {"validator": args.validator}
        )))
    elif args.query_cmd == "invariants":
        print(json.dumps(node.abci_query("custom/crisis/invariants", {})))
    elif args.query_cmd == "metrics":
        # raw Prometheus text — pipe it to a file or a scraper probe
        sys.stdout.write(node.metrics())
    elif args.query_cmd == "timeseries":
        # the continuous-telemetry ring: snapshots + per-metric rates
        # (the server records one fresh sample per call, so repeated
        # queries always have a computable derivative)
        out = node.time_series(last=args.last or None)
        print(json.dumps({
            "node_id": out.get("node_id", ""),
            "samples_kept": out.get("samples_kept", 0),
            "max_samples": out.get("max_samples", 0),
            "snapshots": out.get("snapshots", []),
            "rates": out.get("rates", {}),
        }, indent=1 if args.pretty else None))
    elif args.query_cmd == "alerts":
        # the declarative alert engine's verdicts over the same ring
        out = node.time_series(last=1)
        alerts = out.get("alerts", [])
        firing = [a for a in alerts if a.get("firing")]
        print(json.dumps({
            "node_id": out.get("node_id", ""),
            "firing": len(firing),
            "alerts": firing if args.firing_only else alerts,
        }, indent=1))
        if firing and args.fail_on_firing:
            return 1
    elif args.query_cmd == "block-scorecard":
        # the per-height block scorecard ring: prepare/process walls,
        # extend leg + cache verdict, propagation hop, commit lag and
        # the critical-path top contributors for every recent height
        out = node.block_scorecard(last=args.last or None)
        print(json.dumps(out, indent=1 if args.pretty else None))
    elif args.query_cmd == "host-profile":
        out = node.host_profile(top=args.top, folded=args.folded)
        if args.out:
            Path(args.out).write_text(
                "\n".join(
                    f"{stack} {count}"
                    for stack, count in sorted(
                        out.get("folded", {}).items(),
                        key=lambda kv: (-kv[1], kv[0]),
                    )
                )
                + "\n"
            )
        print(json.dumps({
            "node_id": out.get("node_id", ""),
            "stats": out.get("stats", {}),
            "top_frames": out.get("top_frames", []),
            **({"written": args.out} if args.out
               else {"folded": out.get("folded", {})}),
        }, indent=1))
    elif args.query_cmd == "incidents":
        print(json.dumps(node.flight_list(), indent=1))
    elif args.query_cmd == "incident":
        out = node.flight_fetch(args.id)
        if not out.get("found"):
            print(json.dumps(out))
            return 1
        if args.out:
            written = _write_bundle_files(Path(args.out), out)
            print(json.dumps({
                "id": out["manifest"]["id"],
                "reason": out["manifest"].get("reason", ""),
                "written": written,
            }, indent=1))
        else:
            print(json.dumps({"manifest": out["manifest"]}, indent=1))
    elif args.query_cmd == "cluster-incidents":
        # per-peer incident rollup; with --out, every bundle is pulled
        # mesh-wide into <out>/<node_id>/<incident_id>/
        clients = _cluster_clients(node, args)
        try:
            report = []
            for client in clients:
                addr = str(getattr(client, "address", ""))
                try:
                    listing = client.flight_list()
                except Exception as e:
                    report.append({"node": addr, "error": str(e)[:200]})
                    continue
                entry = {
                    "node": addr,
                    "enabled": listing.get("enabled", False),
                    "incidents": listing.get("incidents", []),
                }
                if args.out and entry["enabled"]:
                    fetched = []
                    for inc in entry["incidents"]:
                        if "error" in inc:
                            continue
                        bundle = client.flight_fetch(inc["id"])
                        if not bundle.get("found"):
                            continue
                        # peer-supplied node id: reduce to a safe slug
                        # (a hostile ".." or "/abs" must stay inside
                        # --out)
                        import re as _re

                        nid = _re.sub(
                            r"[^A-Za-z0-9_.-]+", "_",
                            str(inc.get("node_id") or addr or "node"),
                        ).strip(".") or "node"
                        fetched.extend(_write_bundle_files(
                            Path(args.out) / nid, bundle
                        ))
                    entry["written"] = fetched
                report.append(entry)
            print(json.dumps({
                "peers": report,
                "incidents_total": sum(
                    len(e.get("incidents", [])) for e in report
                ),
            }, indent=1))
        finally:
            _close_clients(clients, node)
    elif args.query_cmd == "trace-dump":
        out = node.trace_dump(last=args.last or None)
        if args.out:
            # write ONLY the Chrome trace document: the file opens in
            # Perfetto / chrome://tracing without editing
            Path(args.out).write_text(json.dumps(out.get("trace", {})))
            print(json.dumps({
                "enabled": out.get("enabled", False),
                "blocks": out.get("blocks", []),
                "written": args.out,
            }))
        else:
            print(json.dumps(out))
    elif args.query_cmd == "cluster-trace":
        # fan trace_dump + clock probes out to every peer and fold the
        # dumps into ONE Perfetto timeline: a node track per peer,
        # offsets applied, cross-node parent links as flow arrows
        from celestia_tpu_torch.node import cluster as cluster_mod
        from celestia_tpu_torch.utils.tracing import validate_chrome_trace

        clients = _cluster_clients(node, args)
        try:
            merged = cluster_mod.cluster_trace(
                clients, last=args.last or None
            )
        finally:
            _close_clients(clients, node)
        problems = validate_chrome_trace(merged)
        if problems:
            raise SystemExit(f"cluster-trace: invalid merge: {problems[:5]}")
        Path(args.out).write_text(json.dumps(merged))
        print(json.dumps({
            "written": args.out,
            "nodes": [n["node_id"] for n in merged["otherData"]["nodes"]],
            "events": len(merged["traceEvents"]),
            "cross_node_flows": merged["otherData"]["cross_node_flows"],
        }))
    elif args.query_cmd == "cluster-health":
        # coordinator-side aggregated health: per-peer height, breaker
        # states, cache hit rates, degradation/shed counts, RPC traffic
        from celestia_tpu_torch.node import cluster as cluster_mod

        clients = _cluster_clients(node, args)
        try:
            print(json.dumps(cluster_mod.cluster_health(clients), indent=1))
        finally:
            _close_clients(clients, node)
    elif args.query_cmd == "namespace-shares":
        # fetch + VERIFY all shares of a namespace like a rollup would
        from celestia_tpu_torch.da import namespace_data as nsd_mod
        from celestia_tpu_torch.da.dah import DataAvailabilityHeader

        out = node.abci_query(
            "custom/namespace/shares",
            {"height": args.height, "namespace": args.namespace},
        )
        rows = tuple(bytes.fromhex(r) for r in out["dah"]["row_roots"])
        cols = tuple(bytes.fromhex(c) for c in out["dah"]["col_roots"])
        dah = DataAvailabilityHeader(
            rows, cols, DataAvailabilityHeader.compute_hash(rows, cols)
        )
        result = nsd_mod.NamespaceData.from_dict(out["data"])
        # trust anchor: the block header's recorded data root, NOT the
        # query response; and the response must answer for the namespace
        # that was ASKED (a self-consistent answer for a different
        # namespace or block must not print verified)
        trusted_root = bytes.fromhex(node.block(int(args.height))["data_root"])
        verified = (
            result.namespace == bytes.fromhex(args.namespace)
            and dah.hash == trusted_root
            and result.verify(dah)
        )
        print(json.dumps({
            "verified": verified,
            "rows": len(result.rows),
            "shares": sum(len(r.shares) for r in result.rows),
            "payload_hex": result.blobs_payload().hex() if verified else "",
        }))
    elif args.query_cmd == "blobstream":
        if args.bs_cmd == "attestation":
            print(json.dumps(node.abci_query(
                "custom/blobstream/attestation", {"nonce": args.nonce}
            )))
        elif args.bs_cmd == "nonce":
            print(json.dumps(node.abci_query(
                "custom/blobstream/latest_nonce", {}
            )))
        elif args.bs_cmd == "range":
            print(json.dumps(node.abci_query(
                "custom/blobstream/data_commitment_range",
                {"height": args.height},
            )))
        elif args.bs_cmd == "verify":
            # client/verify.go VerifyShares parity: prove the shares are
            # covered by a DataCommitment, verifying every link locally
            from celestia_tpu_torch.client.blobstream import (
                BlobstreamVerifyError,
                verify_shares,
            )

            try:
                v = verify_shares(
                    node, int(args.height), int(args.start), int(args.end)
                )
            except BlobstreamVerifyError as e:
                print(json.dumps({"verified": False, "reason": str(e)}))
                return 1
            print(json.dumps({
                "verified": True,
                "height": v.height,
                "data_root": v.data_root.hex(),
                "nonce": v.nonce,
                "begin_block": v.begin_block,
                "end_block": v.end_block,
                "tuple_root": v.tuple_root.hex(),
            }))
    elif args.query_cmd == "das-sample":
        # fetch + VERIFY n random samples like a light client would;
        # the whole draw rides the vectorized serving plane by default
        # (ONE DasSampleBatch stream against a remote node, one
        # row-grouped batch query in-process) — --per-cell keeps the
        # scalar path for comparison/debugging
        from celestia_tpu_torch.da import das as das_mod

        blk = node.block(int(args.height))
        lc = das_mod.LightClient(
            bytes.fromhex(blk["data_root"]), int(blk["square_size"]),
            seed=int(args.seed),
        )

        def fetch(r, c):
            out = node.abci_query(
                "custom/das/sample",
                {"height": args.height, "row": r, "col": c},
            )
            return das_mod.SampleProof.from_dict(out["proof"])

        def fetch_batch(coords):
            if hasattr(node, "das_sample_batch"):
                out = node.das_sample_batch(int(args.height), coords)
            else:
                out = node.abci_query(
                    "custom/das/sample_batch",
                    {
                        "height": args.height,
                        "coords": [[r, c] for r, c in coords],
                    },
                )
            return [
                das_mod.SampleProof.from_dict(d) for d in out["proofs"]
            ]

        if getattr(args, "per_cell", False):
            result = lc.sample(fetch, int(args.samples))
        else:
            result = lc.sample(
                fetch_batch=fetch_batch, n_samples=int(args.samples)
            )
        print(json.dumps({
            "available": result.available,
            "verified": result.verified,
            "confidence": round(result.confidence, 6),
            "failed": [
                {"row": r, "col": c, "reason": why}
                for r, c, why in result.failed
            ],
        }))
    return 0


def _write_bundle_files(out_dir: Path, bundle: dict) -> list:
    """Write one fetched incident bundle (FlightFetch shape) under
    ``out_dir/<incident_id>/`` — manifest + every artifact, exactly the
    on-disk layout the recorder keeps.  Returns the written paths.

    Bundles arrive from REMOTE peers (cluster-incidents walks the PEX
    mesh), so nothing in them is trusted: the incident id must match
    the recorder's own id grammar (a hostile "../x" or absolute id
    would otherwise escape --out via the Path join), and artifact
    names must be bare basenames."""
    from celestia_tpu_torch.utils.flight import _ID_RE

    incident_id = str(bundle["manifest"]["id"])
    if not _ID_RE.match(incident_id):
        raise SystemExit(
            f"refusing to write bundle with hostile incident id "
            f"{incident_id!r}"
        )
    dest = out_dir / incident_id
    dest.mkdir(parents=True, exist_ok=True)
    written = []
    mpath = dest / "manifest.json"
    mpath.write_text(json.dumps(bundle["manifest"], indent=1, sort_keys=True))
    written.append(str(mpath))
    for name, text in sorted(bundle.get("files", {}).items()):
        # artifact names come from the server; never let a hostile one
        # escape the destination directory
        safe = os.path.basename(name)
        if not safe or safe != name:
            continue
        fpath = dest / safe
        fpath.write_text(text)
        written.append(str(fpath))
    return written


def _cluster_clients(seed, args):
    """Clients for a cluster-wide query: the explicit --nodes list, or
    the seed --node plus every peer its PEX surface reports."""
    from celestia_tpu_torch.client.remote import RemoteNode
    from celestia_tpu_torch.node import cluster as cluster_mod

    timeout = getattr(args, "timeout", 120.0)
    nodes = getattr(args, "nodes", None)
    if nodes:
        addrs = [a.strip() for a in nodes.split(",") if a.strip()]
    else:
        addrs = [args.node] + cluster_mod.discover_peers(seed)
    clients, seen = [], set()
    for addr in addrs:
        if addr in seen:
            continue
        seen.add(addr)
        if addr == args.node:
            clients.append(seed)
            continue
        try:
            clients.append(RemoteNode(addr, timeout_s=timeout))
        except Exception as e:
            print(
                json.dumps({"unreachable": addr, "error": str(e)[:120]}),
                file=sys.stderr,
            )
    return clients


def _close_clients(clients, keep) -> None:
    for c in clients:
        if c is not keep:
            c.close()


def cmd_status(args) -> int:
    print(json.dumps(_remote(args).status()))
    return 0


def cmd_coordinator(args) -> int:
    from celestia_tpu_torch.client.remote import RemoteNode
    from celestia_tpu_torch.node.coordinator import PeerValidator, ProcessCoordinator

    peers = [
        PeerValidator(name=f"val-{i}", client=RemoteNode(addr, timeout_s=args.timeout))
        for i, addr in enumerate(args.peers.split(","))
    ]
    coord = ProcessCoordinator(
        peers, block_interval_ns=int(args.block_interval * 1e9)
    )
    produced = 0
    while args.blocks == 0 or produced < args.blocks:
        t0 = time.time()
        coord.produce_block()
        blk = coord.blocks[-1]
        print(
            json.dumps(
                {
                    "height": blk["height"],
                    "proposer": blk["proposer"],
                    "txs": blk["n_txs"],
                    "app_hash": blk["app_hash"].hex()[:16],
                }
            ),
            flush=True,
        )
        produced += 1
        remaining = args.block_interval - (time.time() - t0)
        if remaining > 0 and (args.blocks == 0 or produced < args.blocks):
            # celint: allow(sanctioned-retry) — block-interval pacing: sleep the remainder of the slot, not a retry
            time.sleep(remaining)
    return 0


def cmd_bft_relay(args) -> int:
    from celestia_tpu_torch.client.remote import RemoteNode
    from celestia_tpu_torch.node.coordinator import BFTRelay, PeerValidator
    from celestia_tpu_torch.utils import faults

    peers = [
        PeerValidator(name=f"val-{i}", client=RemoteNode(addr, timeout_s=args.timeout))
        for i, addr in enumerate(args.peers.split(","))
    ]
    relay = BFTRelay(peers)
    produced = 0
    while args.blocks == 0 or produced < args.blocks:
        t0 = time.time()
        height = relay.produce_block()
        app_hash = ""
        for peer in peers:
            try:
                app_hash = peer.client.status().get("app_hash", "")
                break
            except Exception as e:
                faults.note("relay.status", e)
                continue
        print(
            json.dumps({"height": height, "app_hash": app_hash[:16]}),
            flush=True,
        )
        produced += 1
        remaining = args.block_interval - (time.time() - t0)
        if remaining > 0 and (args.blocks == 0 or produced < args.blocks):
            # celint: allow(sanctioned-retry) — block-interval pacing: sleep the remainder of the slot, not a retry
            time.sleep(remaining)
    return 0


def cmd_snapshot(args) -> int:
    from celestia_tpu_torch.node.snapshots import SnapshotStore

    store = SnapshotStore(str(Path(_home(args)) / "data" / "snapshots"))
    if args.snap_cmd == "list":
        for info in store.list():
            print(
                json.dumps(
                    {
                        "height": info.height,
                        "chunks": info.chunks,
                        "app_hash": info.app_hash.hex(),
                        "app_version": info.app_version,
                    }
                )
            )
    elif args.snap_cmd == "info":
        for info in store.list():
            if info.height == args.height:
                meta = store.load_state(info)
                print(
                    json.dumps(
                        {
                            "height": info.height,
                            "chain_id": info.chain_id,
                            "stores": sorted(meta["state"]),
                            "app_hash": info.app_hash.hex(),
                        }
                    )
                )
                return 0
        raise SystemExit(f"no snapshot at height {args.height}")
    return 0


def _gentx_sign_doc(decl: dict, chain_id: str) -> bytes:
    """Canonical bytes a gentx signature covers (sorted-key JSON of the
    declaration + chain id) — collect verifies the operator actually
    holds the validator key they are declaring."""
    import hashlib

    doc = dict(decl)
    doc.pop("signature", None)
    doc["chain_id"] = chain_id
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()
    ).digest()


def cmd_gentx(args) -> int:
    """``gentx`` (cmd/root.go:131-142 genesis-ceremony role): declare
    THIS home's validator for a multi-party genesis — a signed JSON the
    coordinator-less collect-gentxs step verifies and merges."""
    from celestia_tpu_torch.utils.secp256k1 import PrivateKey

    home = Path(_home(args))
    key_file = home / "config" / "priv_validator_key.json"
    genesis_file = home / "config" / "genesis.json"
    if not key_file.exists() or not genesis_file.exists():
        raise SystemExit(f"{home} is not initialised (run init first)")
    if args.power <= 0 or args.self_delegation <= 0:
        # fail where the value originates, not at the remote collector
        raise SystemExit("--power and --self-delegation must be > 0")
    key = PrivateKey(
        int(json.loads(key_file.read_text())["priv_key"], 16)
    )
    chain_id = json.loads(genesis_file.read_text())["chain_id"]
    addr = key.public_key().address()
    decl = {
        "address": addr.hex(),
        "pubkey": key.public_key().compressed().hex(),
        "power": args.power,
        "self_delegation": args.self_delegation,
        "moniker": args.moniker,
    }
    decl["signature"] = key.sign(_gentx_sign_doc(decl, chain_id)).hex()
    out_dir = home / "config" / "gentx"
    out_dir.mkdir(exist_ok=True)
    out = out_dir / f"gentx-{addr.hex()}.json"
    out.write_text(json.dumps(decl, indent=1))
    print(json.dumps({"gentx": str(out), "address": addr.hex()}))
    return 0


def cmd_collect_gentxs(args) -> int:
    """``collect-gentxs``: verify every gentx in --gentx-dir and merge
    the declared validators (+ funding accounts + the BFT valset file)
    into this home's genesis.json — a multi-party genesis without the
    coordinator harness."""
    from celestia_tpu_torch.utils.secp256k1 import PublicKey

    home = Path(_home(args))
    genesis_file = home / "config" / "genesis.json"
    genesis = json.loads(genesis_file.read_text())
    chain_id = genesis["chain_id"]
    gentx_dir = Path(args.gentx_dir) if args.gentx_dir else (
        home / "config" / "gentx"
    )
    files = sorted(gentx_dir.glob("gentx-*.json"))
    if not files:
        raise SystemExit(f"no gentx-*.json files in {gentx_dir}")
    validators = {v["address"]: v for v in genesis.get("validators", [])}
    accounts = {a["address"]: a for a in genesis.get("accounts", [])}
    valset: dict = {}
    for path in files:
        decl = json.loads(path.read_text())
        pub = PublicKey.from_compressed(bytes.fromhex(decl["pubkey"]))
        if pub.address().hex() != decl["address"]:
            raise SystemExit(f"{path.name}: address does not match pubkey")
        if not pub.verify(
            _gentx_sign_doc(decl, chain_id),
            bytes.fromhex(decl["signature"]),
        ):
            raise SystemExit(f"{path.name}: invalid gentx signature")
        if int(decl["power"]) <= 0 or int(decl["self_delegation"]) <= 0:
            raise SystemExit(f"{path.name}: power/self_delegation must be > 0")
        addr = decl["address"]
        vs_entry = {
            "address": addr,
            "pubkey": decl["pubkey"],
            "power": int(decl["power"]),
        }
        # two GENTXS for one address must agree exactly; a gentx freely
        # OVERRIDES a base-genesis validator entry for its own address
        # (the signature proves the signer owns that validator key, so
        # they are the authority over their own declaration — e.g. the
        # placeholder init_home seeds for the home's key)
        if addr in valset and valset[addr] != vs_entry:
            raise SystemExit(
                f"{path.name}: conflicts with another gentx for {addr}"
            )
        valset[addr] = vs_entry
        validators[addr] = {
            "address": addr,
            "self_delegation": int(decl["self_delegation"]),
        }
        # fund the account with the bond plus a liquid buffer: InitChain
        # bonds the whole self-delegation, and a validator with zero
        # spendable balance could not pay its first fee
        accounts.setdefault(
            addr,
            {
                "address": addr,
                "balance": int(decl["self_delegation"]) + 1_000_000_000,
            },
        )
    genesis["validators"] = sorted(
        validators.values(), key=lambda v: v["address"]
    )
    genesis["accounts"] = sorted(
        accounts.values(), key=lambda a: a["address"]
    )
    genesis_file.write_text(json.dumps(genesis, indent=1))
    valset_file = home / "config" / "valset.json"
    valset_file.write_text(
        json.dumps(
            sorted(valset.values(), key=lambda v: v["address"]), indent=1
        )
    )
    print(
        json.dumps(
            {
                "genesis": str(genesis_file),
                "valset": str(valset_file),
                "validators": len(valset),
            }
        )
    )
    return 0


def _genesis_errors(genesis: dict) -> list:
    """Structural checks + the decisive scratch InitChain — shared by
    validate-genesis and download-genesis."""
    errors = []
    if not isinstance(genesis.get("chain_id"), str) or not genesis["chain_id"]:
        errors.append("chain_id must be a non-empty string")
    codec = genesis.get("codec")
    if codec is not None:
        from celestia_tpu_torch.ops import gf256

        if codec not in gf256.CODECS:
            errors.append(f"unknown codec {codec!r} (expected {gf256.CODECS})")
    seen = set()
    for i, acc in enumerate(genesis.get("accounts", [])):
        try:
            addr = bytes.fromhex(acc["address"])
            if len(addr) != 20:
                errors.append(f"accounts[{i}]: address must be 20 bytes")
            if addr in seen:
                errors.append(f"accounts[{i}]: duplicate address")
            seen.add(addr)
            if int(acc["balance"]) < 0:
                errors.append(f"accounts[{i}]: negative balance")
        except (KeyError, ValueError, TypeError) as e:
            errors.append(f"accounts[{i}]: {e}")
    seen = set()
    for i, val in enumerate(genesis.get("validators", [])):
        try:
            addr = bytes.fromhex(val["address"])
            if len(addr) != 20:
                errors.append(f"validators[{i}]: address must be 20 bytes")
            if addr in seen:
                errors.append(f"validators[{i}]: duplicate validator")
            seen.add(addr)
            if int(val["self_delegation"]) <= 0:
                errors.append(f"validators[{i}]: self_delegation must be > 0")
        except (KeyError, ValueError, TypeError) as e:
            errors.append(f"validators[{i}]: {e}")
    if not errors:
        from celestia_tpu_torch.ops import gf256
        from celestia_tpu_torch.state.app import App

        prev_codec = gf256.active_codec()
        try:
            # InitChain is host state work: the scratch App needs no card
            App(chain_id=genesis.get("chain_id", "x"), device="cpu").init_chain(genesis)
        except Exception as e:
            errors.append(f"InitChain rejected the genesis: {e}")
        finally:
            # deliberate restore of a temporary switch — exempt from the
            # pin-once-at-genesis guard
            gf256.set_active_codec(prev_codec, force=True)
    return errors


def cmd_download_genesis(args) -> int:
    """``download-genesis``: fetch the chain's genesis document from a
    running peer over gRPC and install it into this home (the
    reference's download-genesis role, cmd/root.go:131-142).  The doc is
    validated with a scratch InitChain before anything is written; for a
    real deployment cross-check the chain id out of band — one serving
    peer is not a trust anchor."""
    from celestia_tpu_torch.client.remote import RemoteNode

    home = Path(_home(args))
    cfg_dir = home / "config"
    if not cfg_dir.exists():
        raise SystemExit(f"{home} is not initialised (run init first)")
    blocks_log = home / "data" / "blocks.log"
    if (
        not args.force
        and blocks_log.exists()
        and blocks_log.stat().st_size > 0
    ):
        # replacing the genesis under an existing chain's data dir would
        # pair one chain's blocks with another's genesis on next start
        raise SystemExit(
            f"{home} already holds chain data ({blocks_log}); refusing to "
            "replace its genesis — use --force after clearing data/"
        )
    cli = RemoteNode(args.node, timeout_s=args.timeout)
    try:
        doc = cli.genesis()
    finally:
        cli.close()
    if not doc:
        raise SystemExit(f"{args.node} does not serve a genesis document")
    errors = _genesis_errors(doc)
    if errors:
        raise SystemExit(
            "downloaded genesis is invalid: " + "; ".join(errors)
        )
    (cfg_dir / "genesis.json").write_text(json.dumps(doc, indent=1))
    print(
        json.dumps(
            {"genesis": str(cfg_dir / "genesis.json"),
             "chain_id": doc.get("chain_id")}
        )
    )
    return 0


def cmd_migrate_genesis(args) -> int:
    """``migrate-genesis``: bring an older genesis file to the current
    shape.  A file without a codec key is AMBIGUOUS (chains started
    before ADR-012 ran lagrange; files generated by a post-ADR-012
    ``init`` that predates the explicit key ran leopard), so the
    operator must state which chain the file belongs to via
    ``--assume-codec`` — guessing could silently flip the consensus
    codec.  Ordering is canonicalized, the result is validated with the
    same gate as validate-genesis, and an unset genesis time is
    reported (it cannot be invented for an existing chain)."""
    from celestia_tpu_torch.ops import gf256

    path = Path(args.file) if args.file else (
        Path(_home(args)) / "config" / "genesis.json"
    )
    try:
        genesis = json.loads(path.read_text())
    except (OSError, ValueError) as e:
        raise SystemExit(f"cannot read genesis {path}: {e}")
    applied = []
    if "codec" not in genesis:
        if not args.assume_codec:
            raise SystemExit(
                "genesis has no codec key; state the chain's codec with "
                f"--assume-codec {{{', '.join(gf256.CODECS)}}} "
                "(pre-ADR-012 chains ran lagrange-gf256; post-ADR-012 "
                "inits without the key ran leopard-ff8)"
            )
        if args.assume_codec not in gf256.CODECS:
            raise SystemExit(f"unknown codec {args.assume_codec!r}")
        genesis["codec"] = args.assume_codec
        applied.append(f"pinned codec {args.assume_codec}")
    try:
        for section in ("accounts", "validators"):
            entries = genesis.get(section)
            if not entries:
                continue
            ordered = sorted(entries, key=lambda e: e["address"])
            if entries != ordered:
                genesis[section] = ordered
                applied.append(f"canonicalized {section} order")
    except (KeyError, TypeError) as e:
        raise SystemExit(f"malformed {section} entry: {e}")
    warnings = []
    if not genesis.get("genesis_time_ns"):
        warnings.append(
            "genesis_time_ns is unset/zero: supply the chain's original "
            "time or nodes will substitute their own wall clock"
        )
    errors = _genesis_errors(genesis)
    out_path = Path(args.output) if args.output else path
    if not errors:
        out_path.write_text(json.dumps(genesis, indent=1))
    print(
        json.dumps(
            {"output": str(out_path) if not errors else None,
             "applied": applied, "warnings": warnings, "errors": errors}
        )
    )
    return 0 if not errors else 1


def cmd_validate_genesis(args) -> int:
    """``validate-genesis``: structural checks with precise messages,
    then the decisive one — a scratch in-memory App actually runs
    InitChain on the file (what the reference's validate-genesis
    ultimately guards: will every node accept this genesis?)."""
    path = Path(args.file) if args.file else (
        Path(_home(args)) / "config" / "genesis.json"
    )
    try:
        genesis = json.loads(path.read_text())
    except (OSError, ValueError) as e:
        print(json.dumps({"valid": False, "errors": [f"unreadable: {e}"]}))
        return 1
    errors = _genesis_errors(genesis)
    print(json.dumps({"valid": not errors, "errors": errors}))
    return 0 if not errors else 1


def cmd_txsim(args) -> int:
    """Load generator against a running node (test/cmd/txsim parity)."""
    from celestia_tpu_torch.client.signer import Signer
    from celestia_tpu_torch.client import txsim

    node = _remote(args)
    master = Signer(node, _load_key(_home(args), getattr(args, "from_key")))
    sequences = []
    for _ in range(args.blob):
        seq = txsim.BlobSequence(size_max=args.blob_size_max)
        if args.blob_size_max < seq.size_min:
            raise SystemExit(
                f"--blob-size-max {args.blob_size_max} is below the minimum "
                f"blob size {seq.size_min}"
            )
        sequences.append(seq)
    for _ in range(args.send):
        sequences.append(txsim.SendSequence())
    if not sequences:
        raise SystemExit("nothing to do: pass --blob N and/or --send N")
    results = txsim.run_remote(
        node, master, sequences,
        iterations=args.iterations, seed=args.seed, funding=args.funding,
    )
    ok = sum(1 for r in results if r.get("code") == 0)
    print(
        json.dumps(
            {
                "submitted": len(results),
                "succeeded": ok,
                "failed": len(results) - ok,
                "final_height": node.height,
            }
        )
    )
    return 0 if ok == len(results) else 1


def cmd_blocktime(args) -> int:
    """Average block interval over a height range (tools/blocktime)."""
    node = _remote(args)
    last = args.to_height or node.height
    first = max(2, args.from_height)
    if last <= first:
        raise SystemExit("need at least two blocks in range")
    t0 = node.block(first - 1)["time_ns"]
    t1 = node.block(last)["time_ns"]
    avg_s = (t1 - t0) / (last - first + 1) / 1e9
    print(
        json.dumps(
            {"from": first, "to": last, "avg_block_time_s": round(avg_s, 3)}
        )
    )
    return 0


# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="celestia-tpu")
    p.add_argument("--home", default=None, help="node home directory")
    p.add_argument(
        "--cpu-threads", type=int, default=None, metavar="N",
        help="host worker threads for the CPU DA pipeline (native "
             "NMT/SHA hashing, erasure decode, repair fallback); "
             "default: CELESTIA_TPU_TORCH_CPU_THREADS or os.cpu_count()",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("init", help="initialise a node home")
    sp.add_argument("--chain-id", default="celestia-tpu-1")
    sp.add_argument("--overwrite", action="store_true")
    sp.add_argument(
        "--fund-keyring", type=int, default=0, metavar="UTIA",
        help="fund every key already in the home keyring with this balance",
    )
    sp.add_argument(
        "--genesis", default=None, metavar="FILE",
        help="use this shared genesis.json instead of generating one "
             "(multi-validator setups: every home gets the same genesis)",
    )
    sp.set_defaults(fn=cmd_init)

    sp = sub.add_parser("start", help="run the node + gRPC service")
    sp.add_argument("--grpc-address", default=None)
    sp.add_argument("--block-interval", type=float, default=None)
    sp.add_argument("--v2-upgrade-height", type=int, default=None)
    sp.add_argument(
        "--validator", action="store_true",
        help="validator mode: no self-production; an external coordinator "
             "drives consensus through the ConsPrepare/Process/Commit RPCs",
    )
    sp.add_argument(
        "--bft-valset", default=None,
        help="two-phase BFT mode: path to the validator-set JSON "
             '([{"address","pubkey","power"}]); this node prevotes/'
             "precommits with its key and commits only on a 2/3 quorum "
             "it verified itself (a bft-relay shuttles messages)",
    )
    sp.add_argument(
        "--peers", default=None,
        help="p2p gossip mesh (with --bft-valset): comma-separated peer "
             "validator gRPC addresses; consensus messages flood "
             "directly between validators with own round timers — no "
             "relay needed",
    )
    sp.add_argument(
        "--warm-squares", default="1,2,4",
        help="square sizes extended at boot (the kernels built and loaded) "
             "instead of stalling the first live block ('' disables); on a "
             "mesh-active node the mesh-eligible sizes also warm the "
             "sharded programs (size up, e.g. 64,128, for full coverage)",
    )
    sp.add_argument(
        "--mesh", default=None, metavar="SPEC",
        help="multi-chip mesh factoring for the sharded extension path: "
             "'DATAxROW' (e.g. 2x4), 'auto' (default: all devices on the "
             "row axis when >1 accelerator is visible), or 'off' "
             "(CELESTIA_TPU_TORCH_MESH is equivalent; the flag wins)",
    )
    sp.add_argument(
        "--trace", action="store_true",
        help="enable block-lifecycle span tracing (ring-buffered last-N "
             "blocks, served by the TraceDump RPC as Perfetto-compatible "
             "Chrome trace JSON; CELESTIA_TPU_TORCH_TRACE=1 is equivalent)",
    )
    sp.add_argument(
        "--trace-blocks", type=int, default=None, metavar="N",
        help="how many recent block traces the ring keeps (default 8; "
             "CELESTIA_TPU_TORCH_TRACE_BLOCKS is equivalent)",
    )
    sp.add_argument(
        "--metrics-port", type=int, default=None, metavar="PORT",
        help="serve the Prometheus exposition as plain HTTP GET /metrics "
             "on this port (0 = ephemeral; off by default — the Metrics "
             "RPC keeps serving either way)",
    )
    sp.add_argument(
        "--device-profile", nargs="?", const="", default=None, metavar="DIR",
        help="capture a torch.profiler trace (CPU and CUDA activity) "
             "over the node's lifetime, written as Chrome trace JSON into "
             "DIR (default: <home>/data/device-profile) at shutdown",
    )
    sp.add_argument(
        "--timeseries-interval", type=float, default=5.0, metavar="SECONDS",
        help="continuous-telemetry snapshot cadence for the TimeSeries "
             "ring + alert engine (0 disables the sampler; the RPC "
             "still samples on demand)",
    )
    sp.add_argument(
        "--host-profile", nargs="?", const=-1.0, type=float, default=None,
        metavar="HZ",
        help="continuous host profiling: sample every thread's stack at "
             "HZ (default rate when given bare; 0 disables), joined to "
             "live spans and served by the HostProfile RPC; folded "
             "stacks + Chrome sample events land in flight bundles "
             "(CELESTIA_TPU_TORCH_HOST_PROFILE is equivalent)",
    )
    sp.add_argument(
        "--flight-dir", default=None, metavar="DIR",
        help="arm the anomaly flight recorder: alert firing transitions "
             "(and slow blocks over CELESTIA_TPU_TORCH_FLIGHT_SLOW_BLOCK_MS) "
             "dump a bounded incident bundle (trace + timeseries + "
             "metrics + folded stacks + fault notes) into a size-capped "
             "ring of dirs under DIR, served by FlightList/FlightFetch",
    )
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser(
        "coordinator", help="drive consensus across validator processes"
    )
    sp.add_argument("--peers", required=True,
                    help="comma-separated validator gRPC addresses")
    sp.add_argument("--blocks", type=int, default=0,
                    help="produce N blocks then exit (0 = run forever)")
    sp.add_argument("--block-interval", type=float, default=1.0)
    sp.add_argument("--timeout", type=float, default=120.0)
    sp.set_defaults(fn=cmd_coordinator)

    sp = sub.add_parser(
        "bft-relay",
        help="dumb message transport for two-phase BFT validator "
             "processes (forwards gossip + echoes timeouts; never "
             "sequences commits)",
    )
    sp.add_argument("--peers", required=True,
                    help="comma-separated validator gRPC addresses")
    sp.add_argument("--blocks", type=int, default=0,
                    help="relay N blocks then exit (0 = run forever)")
    sp.add_argument("--block-interval", type=float, default=1.0)
    sp.add_argument("--timeout", type=float, default=120.0)
    sp.set_defaults(fn=cmd_bft_relay)

    sp = sub.add_parser("keys", help="manage the file keyring")
    ks = sp.add_subparsers(dest="keys_cmd", required=True)
    ka = ks.add_parser("add")
    ka.add_argument("name")
    ks.add_parser("list")
    kw = ks.add_parser("show")
    kw.add_argument("name")
    sp.set_defaults(fn=cmd_keys)

    sp = sub.add_parser("tx", help="sign + broadcast transactions")
    sp.add_argument("--node", default="127.0.0.1:9090")
    sp.add_argument("--timeout", type=float, default=120.0,
                    help="per-RPC timeout in seconds")
    sp.add_argument("--from", dest="from_key", required=True)
    sp.add_argument("--no-confirm", action="store_true")
    ts = sp.add_subparsers(dest="tx_cmd", required=True)
    t1 = ts.add_parser("send")
    t1.add_argument("to")
    t1.add_argument("amount")
    t2 = ts.add_parser("pay-for-blob")
    t2.add_argument("namespace", help="hex user namespace (<=10 bytes)")
    t2.add_argument("data", help="hex blob data, or @file")
    t3 = ts.add_parser("delegate")
    t3.add_argument("validator")
    t3.add_argument("amount")
    t3 = ts.add_parser("undelegate")
    t3.add_argument("validator")
    t3.add_argument("amount")
    t3 = ts.add_parser("withdraw-rewards")
    t3.add_argument("validator")
    ts.add_parser("withdraw-commission")
    t3 = ts.add_parser("fund-community-pool")
    t3.add_argument("amount")
    t3 = ts.add_parser("grant-allowance")
    t3.add_argument("grantee")
    t3.add_argument("--spend-limit", default=0)
    t3.add_argument("--expiration-ns", default=0)
    t3.add_argument("--period-ns", default=0)
    t3.add_argument("--period-spend-limit", default=0)
    t3 = ts.add_parser("revoke-allowance")
    t3.add_argument("grantee")
    t3 = ts.add_parser("authz-grant")
    t3.add_argument("grantee")
    t3.add_argument("msg_type", help="numeric Msg TYPE id to authorize")
    t3.add_argument("--spend-limit", default=0)
    t3.add_argument("--expiration-ns", default=0)
    ts.add_parser("unjail")
    sp.set_defaults(fn=cmd_tx)

    sp = sub.add_parser("query", help="query node state")
    sp.add_argument("--node", default="127.0.0.1:9090")
    sp.add_argument("--timeout", type=float, default=120.0,
                    help="per-RPC timeout in seconds")
    qs = sp.add_subparsers(dest="query_cmd", required=True)
    q = qs.add_parser("balance")
    q.add_argument("address")
    q = qs.add_parser("account")
    q.add_argument("address")
    q = qs.add_parser("tx")
    q.add_argument("hash")
    q = qs.add_parser("txs", help="search txs by indexed event")
    q.add_argument("--event", required=True,
                   help='e.g. "transfer" or "transfer.recipient=<hex>"')
    q = qs.add_parser("state-proof", help="verified state query")
    q.add_argument("store")
    q.add_argument("key", help="raw store key, hex")
    q.add_argument("--height", type=int, default=0)
    q = qs.add_parser("block")
    q.add_argument("height")
    q = qs.add_parser("param")
    q.add_argument("subspace")
    q.add_argument("key")
    q = qs.add_parser("share-proof")
    q.add_argument("height", type=int)
    q.add_argument("start", type=int)
    q.add_argument("end", type=int)
    q = qs.add_parser("tx-proof")
    q.add_argument("height", type=int)
    q.add_argument("index", type=int)
    q = qs.add_parser("rewards")
    q.add_argument("delegator")
    q.add_argument("validator")
    qs.add_parser("community-pool")
    q = qs.add_parser("signing-info")
    q.add_argument("validator")
    qs.add_parser("invariants")
    qs.add_parser("metrics", help="node Prometheus text exposition")
    q = qs.add_parser(
        "timeseries",
        help="continuous-telemetry snapshots + per-metric rates "
             "(the bounded TimeSeries ring)",
    )
    q.add_argument("--last", type=int, default=0,
                   help="only the most recent N snapshots (0 = all kept)")
    q.add_argument("--pretty", action="store_true",
                   help="indent the JSON output")
    q = qs.add_parser(
        "alerts",
        help="declarative alert-rule verdicts over the telemetry ring "
             "(threshold / sustained-burn / rate / stall rules)",
    )
    q.add_argument("--firing-only", action="store_true",
                   help="print only the rules currently firing")
    q.add_argument("--fail-on-firing", action="store_true",
                   help="exit 1 when any rule fires (CI/automation probe)")
    q = qs.add_parser(
        "block-scorecard",
        help="per-height block scorecard: prepare/process walls, extend "
             "leg, propagation delay, commit lag, critical-path top "
             "contributors",
    )
    q.add_argument("--last", type=int, default=0,
                   help="only the most recent N heights (0 = all kept)")
    q.add_argument("--pretty", action="store_true",
                   help="indent the JSON output")
    q = qs.add_parser(
        "host-profile",
        help="the node's host sampling-profiler view: sampler stats, "
             "top self-time frames, folded stacks (flamegraph input)",
    )
    q.add_argument("--top", type=int, default=25,
                   help="how many self-time frames to report")
    q.add_argument("--folded", type=int, default=200,
                   help="how many folded stacks to include (by count)")
    q.add_argument("--out", default=None,
                   help="also write the folded stacks to this file "
                        "(one 'stack count' line each — feed it to "
                        "flamegraph.pl / speedscope)")
    q = qs.add_parser(
        "incidents",
        help="list the node's kept flight-recorder incident bundles",
    )
    q = qs.add_parser(
        "incident",
        help="fetch one incident bundle (default: the newest) and "
             "write its artifacts to --out",
    )
    q.add_argument("--id", default="",
                   help="incident id (from `query incidents`; default: "
                        "the newest bundle)")
    q.add_argument("--out", default=None,
                   help="directory to write the bundle's files into "
                        "(created; default: print the manifest only)")
    q = qs.add_parser(
        "cluster-incidents",
        help="collect flight-recorder incident lists (and, with --out, "
             "the bundles) from every peer in the mesh",
    )
    q.add_argument("--nodes", default=None,
                   help="comma-separated peer gRPC addresses (default: "
                        "--node plus its PEX-reported peers)")
    q.add_argument("--out", default=None,
                   help="directory to download every peer's bundles into "
                        "(<out>/<node_id>/<incident_id>/...)")
    q = qs.add_parser(
        "trace-dump",
        help="last N block traces as Chrome trace JSON (open in Perfetto)",
    )
    q.add_argument("--last", type=int, default=0,
                   help="only the most recent N block traces (0 = all kept)")
    q.add_argument("--out", default=None,
                   help="write the Chrome trace document to this file")
    q = qs.add_parser(
        "cluster-trace",
        help="fan trace-dump out to every peer and merge into ONE "
             "Perfetto timeline (node tracks, aligned clocks, "
             "cross-node flow links)",
    )
    q.add_argument("--nodes", default=None,
                   help="comma-separated peer gRPC addresses (default: "
                        "--node plus its PEX-reported peers)")
    q.add_argument("--last", type=int, default=0,
                   help="only the most recent N block traces per node")
    q.add_argument("--out", default="cluster.trace.json",
                   help="write the merged Chrome trace document here")
    q = qs.add_parser(
        "cluster-health",
        help="aggregated per-peer health: heights, breaker states, "
             "cache hit rates, degradation/shed counts, RPC traffic",
    )
    q.add_argument("--nodes", default=None,
                   help="comma-separated peer gRPC addresses (default: "
                        "--node plus its PEX-reported peers)")
    q = qs.add_parser("das-sample", help="light-client availability sampling")
    q.add_argument("height", type=int)
    q.add_argument("--samples", type=int, default=16)
    q.add_argument("--seed", type=int, default=0)
    q.add_argument(
        "--per-cell", action="store_true",
        help="fetch each sample with a separate DasSample RPC instead "
             "of the batched serving plane (comparison/debugging)",
    )
    q = qs.add_parser(
        "namespace-shares", help="all shares of a namespace, verified"
    )
    q.add_argument("height", type=int)
    q.add_argument("namespace", help="29-byte namespace, hex")
    q = qs.add_parser(
        "blobstream", help="EVM-bridge attestations + client verification"
    )
    bs = q.add_subparsers(dest="bs_cmd", required=True)
    b = bs.add_parser("attestation")
    b.add_argument("nonce", type=int)
    bs.add_parser("nonce")
    b = bs.add_parser("range", help="DataCommitment window covering a height")
    b.add_argument("height", type=int)
    b = bs.add_parser(
        "verify",
        help="prove shares are covered by a DataCommitment "
             "(client/verify.go VerifyShares parity)",
    )
    b.add_argument("height", type=int)
    b.add_argument("start", type=int)
    b.add_argument("end", type=int)
    sp.set_defaults(fn=cmd_query)

    sp = sub.add_parser("status", help="node status")
    sp.add_argument("--node", default="127.0.0.1:9090")
    sp.add_argument("--timeout", type=float, default=120.0,
                    help="per-RPC timeout in seconds")
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser(
        "gentx", help="declare this home's validator for a shared genesis"
    )
    sp.add_argument("--self-delegation", type=int, default=100_000_000)
    sp.add_argument("--power", type=int, default=100)
    sp.add_argument("--moniker", default="")
    sp.set_defaults(fn=cmd_gentx)

    sp = sub.add_parser(
        "collect-gentxs",
        help="verify + merge gentx files into genesis.json and valset.json",
    )
    sp.add_argument(
        "--gentx-dir", default=None,
        help="directory of gentx-*.json files (default: home/config/gentx)",
    )
    sp.set_defaults(fn=cmd_collect_gentxs)

    sp = sub.add_parser(
        "validate-genesis", help="check a genesis file incl. a scratch InitChain"
    )
    sp.add_argument(
        "--file", default=None,
        help="genesis path (default: home/config/genesis.json)",
    )
    sp.set_defaults(fn=cmd_validate_genesis)

    sp = sub.add_parser(
        "download-genesis",
        help="fetch + validate the genesis document from a running peer",
    )
    sp.add_argument("--node", default="127.0.0.1:9090")
    sp.add_argument("--timeout", type=float, default=120.0)
    sp.add_argument(
        "--force", action="store_true",
        help="replace the genesis even though the home holds chain data",
    )
    sp.set_defaults(fn=cmd_download_genesis)

    sp = sub.add_parser(
        "migrate-genesis",
        help="bring an older genesis file to the current shape",
    )
    sp.add_argument("--file", default=None)
    sp.add_argument("--output", default=None,
                    help="write here instead of in place")
    sp.add_argument(
        "--assume-codec", default=None,
        help="codec to pin when the file has no codec key (required then)",
    )
    sp.set_defaults(fn=cmd_migrate_genesis)

    sp = sub.add_parser("txsim", help="transaction load generator")
    sp.add_argument("--node", default="127.0.0.1:9090")
    sp.add_argument("--timeout", type=float, default=120.0,
                    help="per-RPC timeout in seconds")
    sp.add_argument("--from", dest="from_key", required=True,
                    help="master key (funds the sub-accounts)")
    sp.add_argument("--blob", type=int, default=1, help="blob sequences")
    sp.add_argument("--send", type=int, default=0, help="send sequences")
    sp.add_argument("--iterations", type=int, default=10)
    sp.add_argument("--blob-size-max", type=int, default=10_000)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--funding", type=int, default=10**9)
    sp.set_defaults(fn=cmd_txsim)

    sp = sub.add_parser("snapshot", help="manage state-sync snapshots")
    ss = sp.add_subparsers(dest="snap_cmd", required=True)
    ss.add_parser("list")
    sr = ss.add_parser("info")
    sr.add_argument("height", type=int)
    sp.set_defaults(fn=cmd_snapshot)

    sp = sub.add_parser("blocktime", help="average block interval")
    sp.add_argument("--node", default="127.0.0.1:9090")
    sp.add_argument("--timeout", type=float, default=120.0,
                    help="per-RPC timeout in seconds")
    sp.add_argument("--from-height", type=int, default=2)
    sp.add_argument("--to-height", type=int, default=0)
    sp.set_defaults(fn=cmd_blocktime)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "cpu_threads", None) is not None:
        from celestia_tpu_torch.utils import hostpool

        try:
            hostpool.set_cpu_threads(args.cpu_threads)
        except ValueError as e:
            raise SystemExit(f"--cpu-threads: {e}")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
