"""multichip-smoke: the live mesh path's boot gate, on the port.

Twin of ``tools/multichip_smoke.py``.  JAX's ``force_host_devices_env``
(an XLA flag that splits the host into virtual devices) has no
counterpart: the port's mesh repeats torch devices, so the twin
configures it over ``[device] * R`` (``["cpu"] * 2`` with ``--device
cpu``, ``["cuda:0"] * 2`` on one card; ``--mesh-devices`` names others)
with ``parallel/mesh.py`` ``configure``, as ``CELESTIA_TPU_TORCH_MESH``
does for a node, and drives ONE REAL BLOCK through the live
prepare->process proposal lifecycle of a TestNode on the device with
tracing armed.  Asserts:

* the block committed through the SHARDED path: the prepare trace
  carries the ``extend.sharded`` host span with the mesh factoring in
  its args, and the EDS cache served the process leg warm;
* the merged Chrome trace is schema-valid and holds the sharded
  dispatch record (``device.extend_sharded``, its args naming the whole
  mesh) on the track of each distinct mesh device -- one on a mesh that
  repeats one device;
* the mesh provider reports the sharded extend in its stats;
* >= 2 distinct device tracks -- only when the mesh has >= 2 distinct
  devices (a mesh that repeats one device has one track; the summary
  says which check ran).

Exit 0 + one summary JSON line (with the device, the block's data root,
a digest of its EDS and the launch counts) on success; 1 with the reason on any failure.

    python -m celestia_tpu_torch.tools.multichip_smoke [--device cpu] [--mesh-devices cuda:0,cuda:1]
"""

from __future__ import annotations

import hashlib
import json
import sys

from celestia_tpu_torch import tools

MESH_SPEC = "1x2"  # 2 row shards
ROW_SHARDS = 2
SEED_KEY = b"multichip-smoke"
NAMESPACE_ID = b"\x33" * 10
BLOB = b"\x42" * 600


def smoke(device, mesh_devices=None) -> dict:
    from celestia_tpu_torch import kernels
    from celestia_tpu_torch.client.signer import Signer
    from celestia_tpu_torch.da import eds_cache
    from celestia_tpu_torch.da.blob import Blob, BlobTx
    from celestia_tpu_torch.da.inclusion import create_commitment
    from celestia_tpu_torch.da.namespace import Namespace
    from celestia_tpu_torch.node.testnode import TestNode
    from celestia_tpu_torch.parallel import mesh as mesh_mod
    from celestia_tpu_torch.state.tx import MsgPayForBlobs
    from celestia_tpu_torch.utils import tracing
    from celestia_tpu_torch.utils.secp256k1 import PrivateKey

    devices = list(mesh_devices or [tools.device_label(device)] * ROW_SHARDS)
    mesh_mod.configure(MESH_SPEC, devices=devices)
    try:
        m = mesh_mod.device_mesh()
        assert m is not None, f"mesh did not resolve: {mesh_mod.stats()}"

        tracing.enable(4)
        tracing.clear()
        eds_cache.clear()
        kernels.reset_launch_counts()
        key = PrivateKey.from_seed(SEED_KEY)
        node = TestNode(
            funded_accounts=[(key, 10**12)], auto_produce=False, device=devices[0]
        )
        signer = Signer(node, key)
        # a small blob: the square must land at k >= 2 so the row axis can
        # shard it (a bare MsgSend block is the k=1 min square)
        ns = Namespace.v0(NAMESPACE_ID)
        blob = Blob(ns, BLOB)
        msg = MsgPayForBlobs(
            signer=signer.address,
            namespaces=(ns.raw,),
            blob_sizes=(len(blob.data),),
            share_commitments=(create_commitment(blob),),
            share_versions=(0,),
        )
        tx = signer.sign_tx([msg], gas_limit=2_000_000, sequence=0)
        res = node.broadcast_tx(BlobTx(tx.marshal(), [blob]).marshal())
        assert res.code == 0, f"broadcast failed: {res.log}"
        # one REAL block: reap -> PrepareProposal -> ProcessProposal ->
        # commit, with the extend routed through the mesh
        node.produce_block()
        launches = kernels.launch_counts()

        app = node.app
        assert app.telemetry.counters.get("extend_sharded", 0) >= 1, (
            f"no sharded extend on the live path (counters: "
            f"{dict(app.telemetry.counters)}, mesh: {mesh_mod.stats()})"
        )
        assert app.telemetry.counters.get("eds_cache_hit_process", 0) >= 1, (
            "process leg did not hit the mesh-warmed EDS cache"
        )
        stats = mesh_mod.stats()
        assert stats.get("sharded_extends", 0) >= 1, f"mesh stats: {stats}"

        traces = tracing.block_traces()
        prep = [t for t in traces if t.name == "prepare_proposal"]
        assert prep, "no prepare trace"
        prep = prep[-1]
        sharded_spans = [s for s in prep.spans if s.name == "extend.sharded"]
        assert sharded_spans, (
            f"no extend.sharded span (spans: {sorted({s.name for s in prep.spans})})"
        )
        args = getattr(sharded_spans[0], "args", {}) or {}
        assert args.get("mesh_row") == ROW_SHARDS, (
            f"extend.sharded span lacks mesh args: {args}"
        )
        dispatch_spans = [
            s for s in prep.spans
            if s.cat == "device" and s.name == "device.extend_sharded"
        ]
        # the bracket covers every mesh position and records one span on
        # each distinct device's track (utils/devprof.py), each naming the
        # whole mesh
        assert len(dispatch_spans) == len(set(devices)), (
            f"{len(dispatch_spans)} sharded dispatch records for "
            f"{len(set(devices))} distinct mesh devices"
        )
        for s in dispatch_spans:
            assert (s.args or {}).get("mesh") == MESH_SPEC, s.args

        dump = tracing.trace_dump()
        problems = tracing.validate_chrome_trace(dump)
        assert not problems, f"invalid trace JSON: {problems[:5]}"
        thread_names = {
            ev["args"]["name"]
            for ev in dump["traceEvents"]
            if ev.get("ph") == "M" and ev.get("name") == "thread_name"
        }
        device_tracks = sorted(n for n in thread_names if n.startswith("device:"))
        distinct = len(set(devices))
        if distinct >= 2:
            assert len(device_tracks) >= 2, (
                f"{len(device_tracks)} device track(s) for {distinct} "
                f"distinct devices ({device_tracks})"
            )
            track_check = ">=2 distinct device tracks"
        else:
            assert len(device_tracks) == 1, device_tracks
            track_check = "one track: the mesh repeats one device"

        blk = node.block(node.height)
        eds = node._block_artifacts(node.height)["eds"]
        return {
            "multichip_smoke": "ok",
            "device": tools.device_label(device),
            "mesh_devices": devices,
            "height": node.height,
            "k": blk.header.square_size,
            "data_root": blk.header.data_hash.hex(),
            "eds_sha256": hashlib.sha256(eds.shares.tobytes()).hexdigest(),
            "mesh": stats,
            "sharded_dispatch_spans": len(dispatch_spans),
            "device_tracks": device_tracks,
            "track_check": track_check,
            "launches": launches,
        }
    finally:
        mesh_mod.configure(None)
        tracing.disable()
        tracing.clear()


def main(argv=None) -> int:
    def configure(p):
        p.add_argument("--mesh-devices", default=None,
                       help="comma-separated mesh devices (default: the "
                       f"device {ROW_SHARDS} times)")

    def body(device, args):
        devs = args.mesh_devices.split(",") if args.mesh_devices else None
        print(json.dumps(smoke(device, devs)))

    return tools.run("multichip_smoke", body, argv, __doc__, configure)


if __name__ == "__main__":
    sys.exit(main())
