"""The port's node service (``celestia_tpu_torch/node/server.py`` and its
clients) against the JAX package's.

Both packages' ``NodeService`` run over their own ``TestNode`` on one
seeded stream (``device="cpu"`` for the port).  Each package's Signer
talks to its service through that package's ``RemoteNode`` with the
transport replaced by the service's handlers, so every request is the
bytes RemoteNode sends; the blocks are cut by the test.  The two logs of
(method, request, response) must be equal byte for byte, and so must the
answers of status, broadcast and its batch form, get_tx, account_info,
simulate, block, the query routes, the DAS handlers, genesis and the
snapshot list and chunks.  No field is masked: every one of these answers
carries block time, never wall time.  Then the exposition's families, the
two packages' clients against each other's ``NodeServer`` on 127.0.0.1,
and the service without grpc.  The module resets the port's fault state
itself, so its healthz checks do not depend on which tests ran before it.
"""

import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from celestia_tpu.client import signer as jax_signer
from celestia_tpu.da import eds_cache as jax_eds_cache
from celestia_tpu.da import proof as jax_proof
from celestia_tpu.node import remote as jax_remote
from celestia_tpu.node import server as jax_server
from celestia_tpu.node import testnode as jax_testnode
from celestia_tpu.ops import gf256 as jax_gf256
from celestia_tpu.utils import faults as jax_faults
from celestia_tpu.utils import telemetry as jax_telemetry
from _torch_common import jitted_jax_level_stack, torch_one_thread  # noqa: F401 (fixtures)
from test_torch_node import JAX, PORT, Chain, query_args, stream, submit
from celestia_tpu_torch.client import signer as port_signer
from celestia_tpu_torch.da import eds_cache
from celestia_tpu_torch.da import proof as port_proof
from celestia_tpu_torch.node import remote as port_remote
from celestia_tpu_torch.node import server as port_server
from celestia_tpu_torch.node import testnode as port_testnode
from celestia_tpu_torch.ops import gf256
from celestia_tpu_torch.parallel import mesh
from celestia_tpu_torch.utils import faults, telemetry

ROOT = Path(__file__).resolve().parents[1]
MAX_K = 8
ROUTES = ("custom/das/sample", "custom/das/sample_batch", "custom/namespace/shares",
          "custom/proof/share", "custom/proof/tx")


def in_process(remote_mod, telemetry_mod, service, log: list):
    """``remote_mod.RemoteNode`` whose transport is ``service``'s handlers:
    each call's (method, request, response) is appended to ``log``."""

    class ServiceRemote(remote_mod.RemoteNode):
        def __init__(self):
            self.address, self.timeout_s, self._methods = "in-process", 30.0, {}
            self.chain_id = self.status()["chain_id"]

        def _call(self, method, payload):
            resp = getattr(service, telemetry_mod.snake_case(method))(payload, None)
            log.append((method, payload, resp))
            return resp

        def _call_stream(self, method, payload):
            for resp in getattr(service, telemetry_mod.snake_case(method))(payload, None):
                log.append((method, payload, resp))
                yield resp

    return ServiceRemote()


def clean_state():
    faults.reset_stats()
    jax_faults.reset_stats()
    jax_eds_cache.clear()
    eds_cache.clear()
    mesh._reset_for_tests()


@pytest.fixture(scope="module")
def served(jitted_jax_level_stack, tmp_path_factory):
    """Both packages' node, service and in-process client, driven through
    one seeded stream: a height of sends and PayForBlobs, an overfilled
    height, the pool drained, an empty block; snapshots every 2 heights."""
    clean_state()
    saved = (jax_gf256.active_codec(), gf256.active_codec())
    tmp = tmp_path_factory.mktemp("served")
    sides = {}
    for name, side, server_mod, remote_mod, tel in (
        ("jax", JAX, jax_server, jax_remote, jax_telemetry),
        ("port", PORT, port_server, port_remote, telemetry),
    ):
        chain = Chain(side, gf256.CODEC_LEOPARD, MAX_K, snapshot_dir=str(tmp / name),
                      snapshot_interval=2, auto_produce=False)
        service = server_mod.NodeService(chain.node)
        log = []
        remote = in_process(remote_mod, tel, service, log)
        chain.signers = [side.Signer(remote, s.key) for s in chain.signers]
        sides[name] = types.SimpleNamespace(chain=chain, node=chain.node, service=service,
                                            log=log, remote=remote)
    rng = np.random.default_rng(12)
    hashes = []
    for kind, blocks in (("plain", 1), ("overfill", 1), ("empty", 2)):
        for item in stream(rng, kind, MAX_K):
            got = [submit(s.chain.side, s.chain.signers[item["key"]], item) for s in sides.values()]
            assert got[1].code == 0, got[1].log
            hashes.append(got[1].tx_hash)
        for _ in range(blocks):
            for s in sides.values():
                s.node.produce_block()
        while len(sides["port"].node.mempool):
            for s in sides.values():
                s.node.produce_block()
    assert sides["port"].node.height == sides["jax"].node.height
    yield types.SimpleNamespace(hashes=hashes, **sides)
    jax_gf256.set_active_codec(saved[0])
    gf256.set_active_codec(saved[1])
    clean_state()


def both(served, method: str, req: bytes):
    """One handler's answer from each package's service."""
    out = [getattr(s.service, method)(req, None) for s in (served.jax, served.port)]
    if not isinstance(out[0], bytes):  # a streaming handler
        out = [list(o) for o in out]
    return out


def test_the_client_streams_are_byte_equal(served):
    """Every request the Signers sent through RemoteNode (status,
    account_info, broadcast) and every answer, in order."""
    jax_log, port_log = served.jax.log, served.port.log
    assert [m for m, _, _ in port_log] == [m for m, _, _ in jax_log]
    assert {m for m, _, _ in port_log} >= {"Status", "AccountInfo", "Broadcast"}
    assert port_log == jax_log


def test_broadcast_and_its_batch_form_match_jax(served):
    raws = []
    for side, s, mod in ((JAX, served.jax, jax_signer), (PORT, served.port, port_signer)):
        signer = mod.Signer(s.node, s.chain.signers[0].key)
        msgs = [side.MsgSend(signer.address, bytes(20), 5 + i) for i in range(2)]
        raws.append([signer.sign_tx([m], sequence=signer.sequence + i).marshal()
                     for i, m in enumerate(msgs)])
    assert raws[1] == raws[0]
    got = both(served, "simulate", raws[1][0])
    assert got[1] == got[0] and json.loads(got[1])["gas"] > 0
    req = json.dumps({"txs": [r.hex() for r in raws[1]]}).encode()
    got = both(served, "broadcast_batch", req)
    assert got[1] == got[0] and all(r["code"] == 0 for r in json.loads(got[1])["results"])
    # the same txs again: both refuse them the same way
    got = both(served, "broadcast", raws[1][0])
    assert got[1] == got[0] and json.loads(got[1])["code"] != 0
    for s in (served.jax, served.port):
        s.node.produce_block()
    assert both(served, "status", b"{}")[0] == both(served, "status", b"{}")[1]


def test_reads_match_jax(served):
    node = served.port.node
    addr = served.port.chain.signers[0].address.hex()
    reqs = [("status", b"{}"), ("genesis", b"{}"), ("snapshot_list", b"{}"),
            ("account_info", json.dumps({"address": addr}).encode()),
            ("simulate", b"\x00not a tx")]
    reqs += [("get_tx", json.dumps({"hash": h.hex()}).encode()) for h in served.hashes]
    reqs += [("get_tx", json.dumps({"hash": "00" * 32}).encode())]
    reqs += [("block", json.dumps({"height": b.header.height}).encode()) for b in node.blocks]
    reqs += [("block", json.dumps({"height": node.height + 1}).encode())]
    for path, data in (("store/bank/balance", {"address": addr}),
                       ("custom/auth/account", {"address": addr}),
                       ("custom/params/param", {"subspace": "blob", "key": "GovMaxSquareSize"}),
                       ("no/such/route", {})):
        reqs.append(("query", json.dumps({"path": path, "data": data}).encode()))
    snaps = json.loads(served.port.service.snapshot_list(b"{}", None))["snapshots"]
    assert snaps
    for snap in snaps:
        for idx in range(len(snap["chunk_hashes"])):
            reqs.append(("snapshot_chunk", json.dumps(
                {"height": snap["height"], "format": snap["format"], "idx": idx}).encode()))
    for method, req in reqs:
        got = both(served, method, req)
        assert got[1] == got[0], (method, req)


@pytest.mark.parametrize("route", ROUTES)
def test_proof_routes_and_das_handlers_match_jax(served, route):
    chunks = []
    for blk in served.port.node.blocks:
        h = blk.header.height
        if route == "custom/proof/tx" and not blk.txs:
            continue
        data = query_args(route, blk)
        got = both(served, "query", json.dumps({"path": route, "data": data}).encode())
        assert got[1] == got[0], (route, h)
        value = json.loads(got[1])["value"]
        if route == "custom/das/sample":
            got = both(served, "das_sample", json.dumps(data).encode())
            assert got[1] == got[0]
        elif route == "custom/das/sample_batch":
            got = both(served, "das_sample_batch", json.dumps(data).encode())
            assert got[1] == got[0]
            chunks.append(len(got[1]))
        elif route == "custom/proof/share":
            assert port_proof.ShareInclusionProof.from_dict(value["proof"]).verify(
                blk.header.data_hash)
    if route == "custom/das/sample_batch":
        assert max(chunks) > 1  # a batch streamed in several chunks


def test_the_exposition_has_the_jax_families(served, monkeypatch):
    # process-wide state other tests of this worker may have left: the
    # client RPC counters, the devprof tables and the node id (a server's
    # bind address), the same for both packages
    from celestia_tpu.utils import devprof as jax_devprof
    from celestia_tpu.utils import tracing as jax_tracing
    from celestia_tpu_torch.utils import devprof, tracing

    for remote_mod, tel, prof, tr in ((jax_remote, jax_telemetry, jax_devprof, jax_tracing),
                                      (port_remote, telemetry, devprof, tracing)):
        monkeypatch.setattr(remote_mod, "RPC_TELEMETRY", tel.Telemetry())
        monkeypatch.setattr(tr, "_node_id", "served-node")
        prof.reset()

    def families(text):
        names = set()
        for line in text.splitlines():
            if line and not line.startswith("#"):
                names.add(line.split("{")[0].split(" ")[0])
        return names

    got = [families(s.service.metrics_text()) for s in (served.jax, served.port)]
    # the device plane's cost table: XLA's in the JAX package, the port's own
    got = [{n.replace("celestia_tpu_xla_", "celestia_tpu_kernel_") for n in f} for f in got]
    assert got[1] == got[0]
    assert telemetry.validate_exposition(served.port.service.metrics_text()) == []
    health = served.port.service.healthz()
    assert health["status"] == "ok" and health["height"] == served.port.node.height


@pytest.fixture
def fresh_nodes():
    clean_state()
    saved = (jax_gf256.active_codec(), gf256.active_codec())
    yield
    jax_gf256.set_active_codec(saved[0])
    gf256.set_active_codec(saved[1])
    clean_state()


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_clients_and_servers_interoperate_over_127_0_0_1(fresh_nodes, server_side):
    """A JAX RemoteNode and Signer against the port's NodeServer, and the
    reverse: status, a PayForBlob confirmed, a share proof verified."""
    if server_side == "port":
        server_side_ = (PORT, port_server, port_testnode)
        client = (JAX, jax_remote, jax_proof)
    else:
        server_side_ = (JAX, jax_server, jax_testnode)
        client = (PORT, port_remote, port_proof)
    (sside, server_mod, testnode_mod), (cside, remote_mod, proof_mod) = server_side_, client
    key = sside.Key.from_seed(b"interop")
    node = testnode_mod.TestNode(funded_accounts=[(key, 10**12)], auto_produce=False,
                                 block_interval_ns=10**9, **sside.node_kw)
    with server_mod.NodeServer(node, block_interval_s=0.05, timeseries_interval_s=None) as srv:
        remote = remote_mod.RemoteNode(srv.address, timeout_s=30.0)
        try:
            assert remote.status()["chain_id"] == node.chain_id
            signer = cside.Signer(remote, cside.Key.from_seed(b"interop"))
            blob = cside.Blob(cside.Namespace.v0(b"interop"), bytes(range(256)) * 8)
            res = signer.submit_pay_for_blob([blob])
            assert res.code == 0, res.log
            info = remote.get_tx(res.tx_hash)
            blk = remote.block(info["height"])
            got = remote.abci_query("custom/proof/share",
                                    {"height": info["height"], "start": 0, "end": 2})
            assert proof_mod.ShareInclusionProof.from_dict(got["proof"]).verify(
                bytes.fromhex(blk["data_root"]))
        finally:
            remote.close()


def test_a_failed_launch_ends_the_producer_and_healthz_reports_it(fresh_nodes, monkeypatch):
    """A launch error raised inside ``produce_block`` (the extension's leg:
    on the CPU the host regime's native call, raising as a CUDA error would
    on the card) is not swallowed: the producer loop ends, ``failed`` is
    set with the error, and /healthz answers 503 "failed"."""
    import urllib.error
    import urllib.request

    from celestia_tpu_torch.da import dah

    def failed_launch(square):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(dah, "_native_extend", failed_launch)
    node = port_testnode.TestNode(auto_produce=False, device="cpu")
    height = node.height
    with port_server.NodeServer(node, block_interval_s=0.02, timeseries_interval_s=None,
                                metrics_port=0) as srv:
        assert srv.failed.wait(timeout=30)
        srv._producer.join(timeout=5)
        assert not srv._producer.is_alive()
        assert isinstance(srv.failure, RuntimeError) and "CUDA error" in str(srv.failure)
        health = srv.service.healthz()
        assert health["status"] == "failed" and "CUDA error" in health["producer_failure"]
        assert node.height == height
        with pytest.raises(urllib.error.HTTPError) as got:
            urllib.request.urlopen(f"http://{srv.metrics_http.address}/healthz", timeout=30)
        assert got.value.code == 503
        assert json.loads(got.value.read())["status"] == "failed"


def test_the_service_runs_without_grpc_and_the_server_refuses():
    code = (
        "import json, sys\n"
        "sys.modules['grpc'] = None\n"
        "from celestia_tpu_torch.node import server, remote\n"
        "from celestia_tpu_torch.node.testnode import TestNode\n"
        "from celestia_tpu_torch.client.signer import Signer\n"
        "from celestia_tpu_torch.utils.secp256k1 import PrivateKey\n"
        "from celestia_tpu_torch.state.tx import MsgSend\n"
        "key = PrivateKey.from_seed(b'no-grpc')\n"
        "node = TestNode(funded_accounts=[(key, 10**12)], auto_produce=False, device='cpu')\n"
        "svc = server.NodeService(node)\n"
        "s = Signer(node, key)\n"
        "raw = s.sign_tx([MsgSend(s.address, bytes(20), 7)]).marshal()\n"
        "assert json.loads(svc.broadcast(raw, None))['code'] == 0\n"
        "node.produce_block()\n"
        "assert json.loads(svc.status(b'{}', None))['height'] == node.height\n"
        "assert svc.healthz()['status'] == 'ok'\n"
        "assert 'celestia_tpu_' in svc.metrics_text()\n"
        "assert json.loads(svc.trace_dump(b'{}', None))['enabled'] is False\n"
        "srv = server.NodeServer(node)\n"
        "try:\n"
        "    srv.start()\n"
        "except ImportError as e:\n"
        "    assert 'grpc' in str(e), e\n"
        "    print('REFUSED')\n"
        "try:\n"
        "    remote.RemoteNode('127.0.0.1:1')\n"
        "except ImportError as e:\n"
        "    assert 'grpc' in str(e), e\n"
        "    print('NO CLIENT')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["REFUSED", "NO", "CLIENT"]
