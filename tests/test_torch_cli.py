"""The port's CLI (``python -m celestia_tpu_torch.cli``) against the JAX
package's.

The home-building commands (``keys``, ``init``, ``gentx``,
``collect-gentxs``, ``validate-genesis``, ``migrate-genesis``) run
in-process through each package's ``main`` in a home of its own, with
``os.urandom`` (the keys) and ``time.time_ns`` (the genesis time) fed the
same values: every printed line and every file of the two homes must be
byte-equal once the home's path is masked.  Then ``start`` as a
subprocess under ``CELESTIA_TPU_TORCH_DEVICE=cpu`` serves a client's
PayForBlob and a verified share proof and DAS sample, and exits 0 on
SIGTERM (the same leg ``chip_smoke.py`` phase 4i runs on the card); a home
run for a few heights by the JAX node resumes under the port's ``start``
at its height and app hash; and ``start`` without the switch and without a
card exits non-zero, naming the missing card.
"""

import json
import os
import select
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from celestia_tpu import cli as jax_cli
from celestia_tpu.da import eds_cache as jax_eds_cache
from celestia_tpu.node import config as jax_config
from celestia_tpu.node import testnode as jax_testnode
from celestia_tpu.ops import gf256 as jax_gf256
from celestia_tpu.utils import secp256k1 as jax_secp
from _torch_common import torch_one_thread  # noqa: F401 (fixture)
from celestia_tpu_torch import cli as port_cli
from celestia_tpu_torch.node import remote as port_remote
from celestia_tpu_torch.ops import gf256

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (its CLI node leg)


def run_commands(cli, home: Path, capsys, monkeypatch) -> list:
    """The home-building commands through ``cli.main``; their outputs."""
    rng = np.random.default_rng(21)
    monkeypatch.setattr(os, "urandom", lambda n: rng.bytes(n))
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_123_000_000_000)
    old = {"chain_id": "parity-1", "genesis_time_ns": 1_700_000_000_000_000_000,
           "accounts": [{"address": "ff" * 20, "balance": 5}, {"address": "01" * 20, "balance": 7}],
           "validators": []}
    (home.parent / f"{home.name}-old.json").write_text(json.dumps(old))
    h = str(home)
    argvs = [
        ["--home", h, "keys", "add", "alice"],
        ["--home", h, "keys", "add", "bob"],
        ["--home", h, "init", "--chain-id", "parity-1", "--fund-keyring", "1000000"],
        ["--home", h, "keys", "list"],
        ["--home", h, "keys", "show", "alice"],
        ["--home", h, "gentx", "--moniker", "val-1", "--power", "10"],
        ["--home", h, "collect-gentxs"],
        ["--home", h, "validate-genesis"],
        ["--home", h, "migrate-genesis", "--file", f"{h}-old.json",
         "--assume-codec", "lagrange-gf256", "--output", f"{h}-migrated.json"],
        ["--home", h, "validate-genesis", "--file", f"{h}-migrated.json"],
    ]
    outs = []
    saved = gf256.active_codec(), jax_gf256.active_codec()
    try:
        for argv in argvs:
            rc = cli.main(argv)
            outs.append((rc, capsys.readouterr().out.replace(h, "<home>")))
    finally:
        gf256.set_active_codec(saved[0], force=True)
        jax_gf256.set_active_codec(saved[1], force=True)
    return outs


def tree(home: Path) -> dict:
    files = sorted(p for p in home.parent.glob(f"{home.name}*") if p.is_file())
    files += sorted(p for p in home.rglob("*") if p.is_file())
    return {str(p).replace(str(home), "<home>"): p.read_bytes().replace(
        str(home).encode(), b"<home>") for p in files}


def test_home_commands_give_the_jax_cli_files_and_output(tmp_path, capsys, monkeypatch):
    got = {}
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        home = tmp_path / name
        got[name] = (run_commands(cli, home, capsys, monkeypatch), tree(home))
    assert got["port"][0] == got["jax"][0]
    assert [rc for rc, _ in got["port"][0]] == [0] * 10
    assert got["port"][1] == got["jax"][1]
    assert "<home>/config/valset.json" in got["port"][1]


def test_start_serves_a_client_on_the_cpu_and_exits_on_sigterm(tmp_path):
    """``start`` in its own process; the client commands in this one, through
    the port's ``main`` (their own processes would only add imports)."""
    run = chip_smoke.cli_in_process
    home = str(tmp_path / "home")
    run(home, "keys", "add", "alice")
    run(home, "init", "--chain-id", "cli-cpu-1", "--fund-keyring", "1000000000")
    saved = gf256.active_codec()
    try:
        walls = chip_smoke.cli_node(home, "cpu")
    finally:
        gf256.set_active_codec(saved, force=True)
    assert set(walls) == {"boot", "pay_for_blob", "queries"}


def _start(home: str, env: dict):
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        addr = "127.0.0.1:%d" % sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "celestia_tpu_torch.cli", "--home", home, "start",
         "--grpc-address", addr, "--warm-squares", ""],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return proc, addr


def test_start_exits_1_when_a_launch_fails_in_the_producer(tmp_path):
    """``start`` (``CELESTIA_TPU_TORCH_DEVICE=cpu``) whose extension (the
    host regime's native leg on the CPU) raises as a failed CUDA launch
    would: the node stops and exits 1."""
    home = str(tmp_path / "home")
    chip_smoke.cli_in_process(home, "keys", "add", "alice")
    chip_smoke.cli_in_process(home, "init", "--chain-id", "cli-fail-1")
    code = (
        "import sys\n"
        "from celestia_tpu_torch.da import dah\n"
        "def failed_launch(square):\n"
        "    raise RuntimeError('CUDA error: an illegal memory access was encountered')\n"
        "dah._native_extend = failed_launch\n"
        "from celestia_tpu_torch import cli\n"
        f"sys.exit(cli.main(['--home', {home!r}, 'start', '--grpc-address', '127.0.0.1:0',\n"
        "                    '--warm-squares', '', '--block-interval', '0.05']))\n"
    )
    env = dict(os.environ, CELESTIA_TPU_TORCH_DEVICE="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "block producer failed" in proc.stdout + proc.stderr
    assert "CUDA error: an illegal memory access" in proc.stderr


def test_a_jax_home_resumes_under_the_port_at_its_app_hash(tmp_path, monkeypatch):
    home = tmp_path / "home"
    saved = jax_gf256.active_codec(), gf256.active_codec()
    jax_config.init_home(str(home), chain_id="resume-1")
    genesis = json.loads((home / "config" / "genesis.json").read_text())
    key = jax_secp.PrivateKey(int(json.loads(
        (home / "config" / "priv_validator_key.json").read_text())["priv_key"], 16))
    cfg = jax_config.load_config(str(home))
    # the JAX node as the JAX CLI's start builds it, a few heights with txs
    node = jax_testnode.TestNode(
        chain_id=genesis["chain_id"], genesis=genesis, validator_key=key,
        block_interval_ns=int(cfg.consensus.block_interval_s * 1e9), auto_produce=False,
        min_gas_price=cfg.min_gas_price, v2_upgrade_height=cfg.v2_upgrade_height,
        snapshot_dir=str(home / "data" / "snapshots"), snapshot_interval=cfg.snapshot.interval,
        snapshot_keep_recent=cfg.snapshot.keep_recent, data_dir=str(home / "data"),
    )
    from celestia_tpu.client.signer import Signer
    from celestia_tpu.da.blob import Blob
    from celestia_tpu.da.namespace import Namespace

    signer = Signer(node, key)
    signer.confirm_tx = lambda tx_hash, **kw: None
    for i in range(3):
        signer.submit_pay_for_blob([Blob(Namespace.v0(b"resume"), bytes([i]) * 900)])
        node.produce_block()
    height, app_hash = node.height, node.blocks[-1].header.app_hash
    node.close()
    jax_gf256.set_active_codec(saved[0], force=True)
    jax_eds_cache.clear()
    env = dict(os.environ, CELESTIA_TPU_TORCH_DEVICE="cpu")
    proc, addr = _start(str(home), env)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 60)
        assert ready, proc.stderr.read() if proc.poll() is not None else "no address"
        assert json.loads(proc.stdout.readline())["grpc"] == addr
        remote = port_remote.RemoteNode(addr, timeout_s=30.0)
        status = remote.status()
        remote.close()
        assert status["height"] == height
        assert status["app_hash"] == app_hash.hex()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "recovered chain from disk" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()
        gf256.set_active_codec(saved[1], force=True)


def test_start_without_a_card_or_the_switch_exits_naming_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "CELESTIA_TPU_TORCH_DEVICE"}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "celestia_tpu_torch.cli", "--home", str(tmp_path), "start"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "CELESTIA_TPU_TORCH_DEVICE=cpu" in proc.stderr
    assert time.perf_counter() - t0 < 30  # no wait for a backend
    assert proc.stdout == ""  # nothing served


def test_start_on_the_cpu_gives_torch_the_host_thread_budget(monkeypatch):
    """A node on the CPU runs the native pool and torch's intra-op threads
    on one budget: CELESTIA_TPU_TORCH_CPU_THREADS (or --cpu-threads) bounds
    both, so that three validators on one host can take a third each."""
    import torch

    from celestia_tpu_torch.utils import hostpool

    before = torch.get_num_threads()
    monkeypatch.setenv("CELESTIA_TPU_TORCH_CPU_THREADS", "2")
    try:
        assert port_cli.apply_host_thread_budget() == 2
        assert torch.get_num_threads() == 2 and hostpool.cpu_threads() == 2
        hostpool.set_cpu_threads(3)  # --cpu-threads wins over the env
        assert port_cli.apply_host_thread_budget() == 3
        assert torch.get_num_threads() == 3
    finally:
        hostpool.set_cpu_threads(None)
        torch.set_num_threads(before)
