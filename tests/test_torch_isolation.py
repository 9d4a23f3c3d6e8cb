"""The port stands alone: celestia_tpu_torch (and chip_smoke.py) import
neither jax nor anything of celestia_tpu, and the port's main path runs
with both unimportable."""

import ast
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
        "eds2, hdr2 = dah.extend_and_header(sq2, device='cpu')\n"
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
