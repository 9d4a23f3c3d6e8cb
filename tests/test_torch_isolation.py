"""The port stands alone: celestia_tpu_torch (and chip_smoke.py) import
neither jax nor anything of celestia_tpu, and the port's main path runs
with both unimportable."""

import ast
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "celestia_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    # exact top-level names: celestia_tpu_torch starts with celestia_tpu
    return module.split(".")[0] in FORBIDDEN


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = sorted((ROOT / "celestia_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [
        f"{f.relative_to(ROOT)}: {m}" for f in files for m in _imported_modules(f) if _forbidden(m)
    ]
    assert not bad, bad


def test_forbidden_rule_is_exact():
    assert _forbidden("celestia_tpu") and _forbidden("celestia_tpu.ops.gf256")
    assert _forbidden("jax.numpy")
    assert not _forbidden("celestia_tpu_torch.ops.gf256")


def test_main_path_runs_with_jax_and_celestia_tpu_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['celestia_tpu'] = None\n"
        "from celestia_tpu_torch.da import dah, golden, square\n"
        "from celestia_tpu_torch.da import das, device_plane, eds_cache, namespace_data, proof\n"
        "from celestia_tpu_torch.ops import gather, gf256, nmt, rs, sha256\n"
        "from celestia_tpu_torch.utils import lru\n"
        "from celestia_tpu_torch import kernels\n"
        "sq, txs, _ = square.build([b'\\x05' * 700, b'\\x06' * 900])\n"
        "eds, hdr = dah.extend_block(sq, device='cpu')\n"
        "hdr.validate_basic()\n"
        "assert dah.min_data_availability_header(device='cpu').hash == golden.MIN_DAH_HASH\n"
        "# a k = 2 serving round trip: DAS from the plane, then from the host\n"
        "rng = __import__('numpy').random.default_rng(3)\n"
        "sq2 = rng.integers(0, 256, (2, 2, 512), dtype='uint8')\n"
        "sq2[..., :29] = 0\n"
        "eds2, hdr2 = device_plane.extend_and_header(sq2, device='cpu')\n"
        "cells = [(r, c) for r in range(4) for c in range(4)]\n"
        "warm = das.sample_proofs_batch(eds2, hdr2, cells)\n"
        "assert das.host_prover_calls() == 0 and all(p.verify(hdr2.hash) for p in warm)\n"
        "assert eds_cache.drop_device_entry(hdr2.hash)\n"
        "assert das.sample_proofs_batch(eds2, hdr2, cells) == warm\n"
        "assert das.host_prover_calls() == 1\n"
        "assert device_plane.sample_proofs_from_eds(eds2.tensor, hdr2, cells) == warm\n"
        "assert proof.new_share_inclusion_proof(eds2, hdr2, 0, 3).verify(hdr2.hash)\n"
        "nd = namespace_data.get_shares_by_namespace(eds2, hdr2, bytes(sq2[0, 0, :29]))\n"
        "assert nd.verify(hdr2) and nd.rows\n"
        "assert 'eds_device' in lru.registry_stats()['caches']\n"
        "# the host regime on the same square: the plane's bytes\n"
        "eds3, hdr3 = dah.extend_and_header(sq2, device='cpu')\n"
        "assert hdr3 == hdr2 and (eds3.shares == eds2.shares).all()\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or m == 'celestia_tpu'\n"
        "               or m.startswith('celestia_tpu.') for m, v in sys.modules.items()\n"
        "               if v is not None)\n"
        "print('OK', hdr.hash.hex())\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK ")


def test_repair_fraud_and_catch_up_run_with_jax_and_celestia_tpu_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['celestia_tpu'] = None\n"
        "import numpy as np\n"
        "from celestia_tpu_torch.da import dah, fraud\n"
        "from celestia_tpu_torch.ops import rs\n"
        "rng = np.random.default_rng(5)\n"
        "sq = rng.integers(0, 256, (2, 4, 4, 512), dtype='uint8')\n"
        "sq[..., :29] = 0\n"
        "eds, hdr = dah.extend_and_header(sq[0], device='cpu')\n"
        "shares = eds.shares\n"
        "# repair: withheld cells back, checked against the DAH's roots\n"
        "avail = np.ones((8, 8), dtype=bool)\n"
        "avail[:3, :5] = False\n"
        "roots = [np.frombuffer(b''.join(r), dtype='uint8').reshape(8, 90)\n"
        "         for r in (hdr.row_roots, hdr.col_roots)]\n"
        "got = rs.repair_square_device(shares, avail, *roots, device='cpu')\n"
        "assert (got == shares).all() and (rs.repair_square(shares, avail) == shares).all()\n"
        "# fraud: a corrupted Q1 cell, recommitted, detected and proven\n"
        "bad = shares.copy()\n"
        "bad[1, 5, 100] ^= 0x5A\n"
        "bad_hdr = dah.new_data_availability_header(dah.ExtendedDataSquare(bad), device='cpu')\n"
        "found = fraud.detect_bad_encoding(bad, device='cpu')\n"
        "assert found == ('row', 1), found\n"
        "befp = fraud.build_befp(bad, *found, device='cpu')\n"
        "assert befp.verify(bad_hdr) and not befp.verify(hdr)\n"
        "# catch-up: a batch of two blocks' data roots\n"
        "_, data_roots = dah.data_roots_batched(sq, device='cpu')\n"
        "assert data_roots[0] == hdr.hash\n"
        "assert data_roots[1] == dah.extend_and_header(sq[1], device='cpu')[1].hash\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or m == 'celestia_tpu'\n"
        "               or m.startswith('celestia_tpu.') for m, v in sys.modules.items()\n"
        "               if v is not None)\n"
        "print('OK')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_sharded_extension_runs_with_jax_and_celestia_tpu_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['celestia_tpu'] = None\n"
        "import numpy as np\n"
        "from celestia_tpu_torch.da import dah\n"
        "from celestia_tpu_torch.parallel import collectives, mesh, sharded\n"
        "rng = np.random.default_rng(7)\n"
        "sq = rng.integers(0, 256, (4, 4, 512), dtype='uint8')\n"
        "sq[..., :29] = 0\n"
        "m = sharded.make_mesh(['cpu'] * 4)\n"
        "eds, hdr = sharded.extend_and_header_sharded(sq, m)\n"
        "eds1, hdr1 = dah.extend_and_header(sq, device='cpu')\n"
        "assert hdr == hdr1 and (eds.shares == eds1.shares).all()\n"
        "mesh.configure('1x4', devices=['cpu'] * 4)\n"
        "assert mesh.mesh_for_square(4) is not None and mesh.mesh_for_square(2) is None\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or m == 'celestia_tpu'\n"
        "               or m.startswith('celestia_tpu.') for m, v in sys.modules.items()\n"
        "               if v is not None)\n"
        "print('OK', hdr.hash.hex())\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK ")


def test_app_block_runs_with_jax_and_celestia_tpu_unimportable():
    """The App closure (state, modules, inclusion, the host utilities and
    the native library) imports and runs one prepare -> process ->
    finalize with jax and celestia_tpu unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['celestia_tpu'] = None\n"
        "from celestia_tpu_torch.da import inclusion\n"
        "from celestia_tpu_torch.da.blob import Blob, BlobTx\n"
        "from celestia_tpu_torch.da.namespace import Namespace\n"
        "from celestia_tpu_torch.state.app import App\n"
        "from celestia_tpu_torch.state.modules.blob import estimate_gas\n"
        "from celestia_tpu_torch.state.tx import Fee, MsgPayForBlobs, MsgSend, Tx\n"
        "from celestia_tpu_torch.utils.secp256k1 import PrivateKey\n"
        "key = PrivateKey.from_seed(b'isolated')\n"
        "addr = key.public_key().address()\n"
        "app = App(chain_id='iso-1', device='cpu')\n"
        "app.init_chain({'chain_id': 'iso-1', 'genesis_time_ns': 10**18,\n"
        "                'accounts': [{'address': addr.hex(), 'balance': 10**12}]})\n"
        "blob = Blob(Namespace.v0(b'\\x01' * 10), b'\\x42' * 3000)\n"
        "pfb = MsgPayForBlobs(addr, (blob.namespace.raw,), (3000,),\n"
        "                     (inclusion.create_commitment(blob),), (0,))\n"
        "gas = estimate_gas([3000])\n"
        "tx = Tx((pfb,), Fee(gas, gas), key.public_key().compressed(), 0, 0)\n"
        "btx = BlobTx(tx.signed(key, 'iso-1').marshal(), (blob,)).marshal()\n"
        "send = Tx((MsgSend(addr, b'\\x02' * 20, 5),), Fee(300, 100_000),\n"
        "          key.public_key().compressed(), 1, 0).signed(key, 'iso-1').marshal()\n"
        "assert [app.check_tx(t).code for t in (btx, send)] == [0, 0]\n"
        "p = app.prepare_proposal([btx, send])\n"
        "assert len(p.block_txs) == 2 and p.eds.tensor.device.type == 'cpu'\n"
        "assert app.process_proposal(p.block_txs, p.square_size, p.data_root) == (True, '')\n"
        "res, end, app_hash = app.finalize_block(p.block_txs, 2, 10**18 + 15 * 10**9,\n"
        "                                        p.data_root)\n"
        "assert [r.code for r in res] == [0, 0] and len(app_hash) == 32\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or m == 'celestia_tpu'\n"
        "               or m.startswith('celestia_tpu.') for m, v in sys.modules.items()\n"
        "               if v is not None)\n"
        "print('OK', p.data_root.hex(), app_hash.hex())\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK ")


def test_devnet_runs_with_jax_and_celestia_tpu_unimportable():
    """The node layer and the clients (state/disk, node/*, client/*)
    import with jax and celestia_tpu unimportable, and a TestNode on the
    CPU takes a Signer's PayForBlob into a block and proves it."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['celestia_tpu'] = None\n"
        "from celestia_tpu_torch.state import disk\n"
        "from celestia_tpu_torch.node import (bft, bft_network, malicious, mempool,\n"
        "                                     network, snapshots, testnode)\n"
        "from celestia_tpu_torch.client import errors, signer, txsim\n"
        "from celestia_tpu_torch.da.blob import Blob\n"
        "from celestia_tpu_torch.da.namespace import Namespace\n"
        "from celestia_tpu_torch.utils.secp256k1 import PrivateKey\n"
        "key = PrivateKey.from_seed(b'isolated-devnet')\n"
        "node = testnode.TestNode(funded_accounts=[(key, 10**12)], device='cpu',\n"
        "                         genesis_time_ns=10**18)\n"
        "s = signer.Signer(node, key)\n"
        "res = s.submit_pay_for_blob([Blob(Namespace.v0(b'\\x01' * 10), b'\\x42' * 3000)])\n"
        "assert res.code == 0 and res.height == node.height == 2\n"
        "blk = node.block(2)\n"
        "q = node.abci_query('custom/proof/share', {'height': 2, 'start': 0, 'end': 2})\n"
        "assert q['data_root'] == blk.header.data_hash.hex()\n"
        "assert node.app.device.type == 'cpu'\n"
        "assert not any(m == 'jax' or m.startswith('jax.') or m == 'celestia_tpu'\n"
        "               or m.startswith('celestia_tpu.') for m, v in sys.modules.items()\n"
        "               if v is not None)\n"
        "print('OK', blk.header.data_hash.hex(), blk.header.app_hash.hex())\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK ")


def test_node_service_runs_with_jax_celestia_tpu_and_grpc_unimportable():
    """The node as users start it (cli, node/server, node/remote,
    node/config, client/remote, client/blobstream and the observability
    utils) imports with jax, celestia_tpu and grpc unimportable, and a
    traced NodeService on the CPU takes a broadcast into a block, serves a
    DAS batch and exposes its device plane."""
    code = (
        "import importlib, json, sys\n"
        "for name in ('jax', 'jaxlib', 'celestia_tpu', 'grpc'):\n"
        "    sys.modules[name] = None\n"
        "for name in ('cli', 'node.server', 'node.remote', 'node.config', 'client.remote',\n"
        "             'client.blobstream', 'utils.devprof', 'utils.hostprof',\n"
        "             'utils.timeseries', 'utils.critpath', 'utils.flight',\n"
        "             'utils.lockwatch'):\n"
        "    importlib.import_module('celestia_tpu_torch.' + name)\n"
        "from celestia_tpu_torch.client.signer import Signer\n"
        "from celestia_tpu_torch.da.blob import Blob\n"
        "from celestia_tpu_torch.da.namespace import Namespace\n"
        "from celestia_tpu_torch.node.server import NodeService\n"
        "from celestia_tpu_torch.node.testnode import TestNode\n"
        "from celestia_tpu_torch.state.tx import MsgSend\n"
        "from celestia_tpu_torch.utils import tracing\n"
        "from celestia_tpu_torch.utils.secp256k1 import PrivateKey\n"
        "key = PrivateKey.from_seed(b'isolated-service')\n"
        "node = TestNode(funded_accounts=[(key, 10**12)], device='cpu', auto_produce=False,\n"
        "                genesis_time_ns=10**18)\n"
        "svc = NodeService(node)\n"
        "tracing.enable()\n"
        "s = Signer(node, key)\n"
        "s.confirm_tx = lambda tx_hash, **kw: None\n"
        "blob = Blob(Namespace.v0(b'\\x01' * 10), b'\\x42' * 3000)\n"
        "s.submit_pay_for_blob([blob])\n"
        "raw = s.sign_tx([MsgSend(s.address, bytes(20), 5)]).marshal()\n"
        "assert json.loads(svc.broadcast(raw, None))['code'] == 0\n"
        "blk = node.produce_block()\n"
        "assert json.loads(svc.status(b'{}', None))['height'] == blk.header.height\n"
        "assert len(blk.txs) == 2\n"
        "req = json.dumps({'height': blk.header.height, 'coords': [[0, 0], [3, 1]]}).encode()\n"
        "chunks = [json.loads(c) for c in svc.das_sample_batch(req, None)]\n"
        "assert sum(len(c['proofs']) for c in chunks) == 2\n"
        "# the node's CPU blocks ran the host regime: no dispatch; the plane,\n"
        "# called directly, is exposed\n"
        "assert 'kernel=\"extend_levels\"' not in svc.metrics_text()\n"
        "import numpy as np\n"
        "from celestia_tpu_torch.da import device_plane\n"
        "device_plane.extend_and_header(np.zeros((2, 2, 512), dtype='uint8'), device='cpu')\n"
        "text = svc.metrics_text()\n"
        "assert 'celestia_tpu_kernel_bytes{kernel=\"extend_levels\"}' in text\n"
        "doc = json.loads(svc.trace_dump(b'{}', None))['trace']\n"
        "assert tracing.validate_chrome_trace(doc) == []\n"
        "assert svc.healthz()['status'] == 'ok'\n"
        "assert not any(m.split('.')[0] in ('jax', 'celestia_tpu', 'grpc')\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print('OK', blk.header.data_hash.hex())\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK ")


def test_default_device_is_the_card():
    from celestia_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_network_stack_runs_with_jax_and_celestia_tpu_unimportable(tmp_path):
    """The network stack (node/gossip, node/coordinator, node/cluster,
    client/swarm, txsim.run_remote) imports with jax and celestia_tpu
    unimportable, and each CLI command that reaches it runs on the CPU:
    ``start --bft-valset --peers`` (a one-validator mesh) commits heights,
    ``query cluster-health``, ``cluster-trace`` and ``cluster-incidents``
    roll it up, ``txsim`` lands its load, ``bft-relay`` drives a height,
    ``coordinator`` one block of a ``NodeServer`` in the same process,
    and SIGTERM ends ``start`` with 0."""
    code = (
        "import contextlib, io, importlib, json, os, signal, sys, threading, time\n"
        "for name in ('jax', 'jaxlib', 'celestia_tpu'):\n"
        "    sys.modules[name] = None\n"
        "for name in ('node.gossip', 'node.coordinator', 'node.cluster', 'client.swarm'):\n"
        "    importlib.import_module('celestia_tpu_torch.' + name)\n"
        "from celestia_tpu_torch import cli\n"
        "from celestia_tpu_torch.client import txsim\n"
        "from celestia_tpu_torch.node.remote import RemoteNode\n"
        "from celestia_tpu_torch.node.server import NodeServer\n"
        "from celestia_tpu_torch.node.testnode import TestNode\n"
        "from celestia_tpu_torch.utils.secp256k1 import PrivateKey\n"
        "assert callable(txsim.run_remote)\n"
        "home, addr = sys.argv[1], sys.argv[2]\n"
        "quiet = io.StringIO()\n"
        "with contextlib.redirect_stdout(quiet):\n"
        "    assert cli.main(['--home', home, 'keys', 'add', 'alice']) == 0\n"
        "    assert cli.main(['--home', home, 'init', '--chain-id', 'iso-mesh-1',\n"
        "                     '--fund-keyring', str(10**12)]) == 0\n"
        "key = PrivateKey(int(json.load(open(home + '/config/priv_validator_key.json'))\n"
        "                     ['priv_key'], 16))\n"
        "valset = home + '/valset.json'\n"
        "json.dump([{'address': key.public_key().address().hex(),\n"
        "            'pubkey': key.public_key().compressed().hex(), 'power': 100}],\n"
        "          open(valset, 'w'))\n"
        "out = {}\n"
        "def client(*argv):\n"
        "    buf = io.StringIO()\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        rc = cli.main(['--home', home, *argv])\n"
        "    return rc, buf.getvalue()\n"
        "def drive():\n"
        "    try:\n"
        "        deadline = time.time() + 60\n"
        "        while time.time() < deadline:\n"
        "            try:\n"
        "                r = RemoteNode(addr, timeout_s=10)\n"
        "                break\n"
        "            except Exception:\n"
        "                time.sleep(0.1)\n"
        "        while r.height < 3 and time.time() < deadline:\n"
        "            time.sleep(0.05)\n"
        "        out['height'] = r.height\n"
        "        rc, text = client('query', '--node', addr, 'cluster-health')\n"
        "        out['health'] = (rc, json.loads(text)['reachable'])\n"
        "        rc, text = client('query', '--node', addr, 'cluster-trace', '--out',\n"
        "                          home + '/cluster.json')\n"
        "        out['trace'] = (rc, json.loads(text)['nodes'])\n"
        "        rc, text = client('query', '--node', addr, 'cluster-incidents')\n"
        "        out['incidents'] = (rc, json.loads(text)['incidents_total'])\n"
        "        rc, text = client('txsim', '--node', addr, '--from', 'alice', '--blob', '1',\n"
        "                          '--send', '1', '--iterations', '1', '--blob-size-max', '900')\n"
        "        rep = json.loads(text)\n"
        "        out['txsim'] = (rc, rep['submitted'], rep['succeeded'])\n"
        "        rc, text = client('bft-relay', '--peers', addr, '--blocks', '1')\n"
        "        out['relay'] = (rc, json.loads(text.splitlines()[-1])['height'] > 0)\n"
        "        plain = TestNode(device='cpu', auto_produce=False, genesis_time_ns=10**18)\n"
        "        srv = NodeServer(plain, block_interval_s=None)\n"
        "        srv.start()\n"
        "        rc, text = client('coordinator', '--peers', srv.address, '--blocks', '1')\n"
        "        out['coordinator'] = (rc, json.loads(text)['height'])\n"
        "        srv.stop()\n"
        "        r.close()\n"
        "    finally:\n"
        "        os.kill(os.getpid(), signal.SIGTERM)\n"
        "t = threading.Thread(target=drive)\n"
        "t.start()\n"
        "with contextlib.redirect_stdout(quiet):\n"
        "    rc = cli.main(['--home', home, 'start', '--bft-valset', valset, '--peers',\n"
        "                   '127.0.0.1:1', '--grpc-address', addr, '--block-interval', '0.05',\n"
        "                   '--warm-squares', '1', '--timeseries-interval', '0'])\n"
        "t.join()\n"
        "assert not any(m.split('.')[0] in ('jax', 'celestia_tpu')\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print(json.dumps({'start': rc, **out}))\n"
    )
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        addr = "127.0.0.1:%d" % sock.getsockname()[1]
    env = {**os.environ, "CELESTIA_TPU_TORCH_DEVICE": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "home"), addr], cwd=ROOT,
                          capture_output=True, text=True, timeout=180, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["start"] == 0 and got["height"] >= 3
    assert got["health"] == [0, 1] and got["trace"][0] == 0 and got["incidents"] == [0, 0]
    assert got["txsim"] == [0, 2, 2] and got["relay"] == [0, True]
    assert got["coordinator"] == [0, 2]
