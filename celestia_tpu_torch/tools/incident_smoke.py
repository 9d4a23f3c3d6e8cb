"""incident-smoke: the host-profiling + flight-recorder boot gate, on the
port.

Twin of ``tools/incident_smoke.py``.  Each node is a ``python -m
celestia_tpu_torch.cli`` process on the device (``cuda:0``, or ``--device
cpu``) under ``CELESTIA_TPU_TORCH_DEVICE``, ``CELESTIA_TPU_TORCH_TRACE``,
``CELESTIA_TPU_TORCH_NODE_ID`` and ``CELESTIA_TPU_TORCH_ALERT_RULES``.

Leg 1 (armed, one real node subprocess): starts a traced tiny-k
validator with the host sampler armed (``--host-profile``), a flight
dir (``--flight-dir``), the plain-HTTP endpoint and a fast
time-series cadence, plus a synthetic height-stall rule injected via
CELESTIA_TPU_TORCH_ALERT_RULES.  Drives ONE block through the real
ConsPrepare/ConsCommit RPCs (the node is then height-stalled by
construction: nothing drives it further), waits for the stall rule to
fire, and asserts against the LIVE RPC surface:

* `query incidents` lists >= 1 bundle,
* `query incident --out DIR` retrieves it; the written manifest passes
  ``flight.validate_manifest``, the written trace passes
  ``tracing.validate_chrome_trace`` and carries >= 1 ``cat="sample"``
  event on a NAMED host thread track, and the folded stacks are
  non-empty,
* `query host-profile` reports live sampling,
* ``GET /healthz`` answers degraded and names the stall rule.

Leg 2 (disarmed): a node WITHOUT ``--host-profile``/``--flight-dir``
must write no flight dir and report a disabled profiler over the same
RPCs, and the disarmed sampler surface must add <1% to a 10k-iteration
work loop (the in-process overhead pin).

Exit 0 + one summary JSON line per leg (with the device and the node's
launch counts) on success; 1 with the reason on any failure.

    python -m celestia_tpu_torch.tools.incident_smoke [--device cpu]
"""

import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

from celestia_tpu_torch import tools

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STALL_RULE = {
    "name": "smoke_height_stall",
    "metric": "height",
    "kind": "stall",
    "for_s": 0.5,
}




def _env(device, extra=None):
    env = {
        **os.environ,
        "CELESTIA_TPU_TORCH_DEVICE": device,
    }
    env.update(extra or {})
    return env


def _cli(env, *args):
    return subprocess.run(
        [sys.executable, "-m", "celestia_tpu_torch.cli", *args],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env,
    )


def _start_node(base, name, env, extra_flags):
    home = os.path.join(base, name)
    r = _cli(env, "--home", home, "init", "--chain-id", f"{name}-1")
    if r.returncode != 0:
        print(f"incident-smoke: init failed: {r.stderr}", file=sys.stderr)
        return None, home
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "celestia_tpu_torch.cli",
            "--home", home, "start", "--validator",
            "--grpc-address", "127.0.0.1:0",
            "--metrics-port", "0",
            "--timeseries-interval", "0.2",
            "--warm-squares", "",
            *extra_flags,
        ],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, cwd=REPO, env=env,
    )
    return proc, home


def _node_counts(addr) -> dict:
    from celestia_tpu_torch.client.remote import RemoteNode

    remote = RemoteNode(addr, timeout_s=120.0)
    try:
        return tools.exposition_counts(remote.metrics())
    finally:
        remote.close()


def _stop_node(proc):
    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()


def _produce_one_block(addr):
    """One real block over the consensus RPCs: prepare on the validator,
    commit the proposal straight back (single-validator quorum)."""
    from celestia_tpu_torch.client.remote import RemoteNode

    remote = RemoteNode(addr, timeout_s=120.0)
    try:
        st = remote.status()
        prop = remote.cons_prepare()
        now_ns = int(
            st.get("time_ns") or st.get("genesis_time_ns") or 0
        ) + 10**9
        remote.cons_commit(
            prop["block_txs"], int(st["height"]) + 1, now_ns,
            prop["data_root"], prop["square_size"],
        )
        return remote.status()["height"]
    finally:
        remote.close()


def leg1(device: str) -> int:
    from celestia_tpu_torch.utils import flight as flight_mod
    from celestia_tpu_torch.utils import tracing

    base = tempfile.mkdtemp(prefix="incident-smoke-")
    flight_dir = os.path.join(base, "flight")
    env = _env(device, {
        "CELESTIA_TPU_TORCH_TRACE": "1",
        "CELESTIA_TPU_TORCH_ALERT_RULES": json.dumps([STALL_RULE]),
        "CELESTIA_TPU_TORCH_NODE_ID": "incident-smoke-node",
    })
    proc, _home = _start_node(
        base, "armed", env,
        ["--host-profile", "200", "--flight-dir", flight_dir],
    )
    if proc is None:
        return 1
    try:
        line = tools.readline_deadline(proc)
        if line is None or proc.poll() is not None:
            why = "died" if proc.poll() is not None else "hung"
            print(f"incident-smoke: validator {why} at startup",
                  file=sys.stderr)
            return 1
        started = json.loads(line)
        addr, http_addr = started["grpc"], started.get("metrics_http")
        height = _produce_one_block(addr)
        if height < 1:
            print(f"incident-smoke: no block produced (h={height})",
                  file=sys.stderr)
            return 1
        # the node is now height-stalled by construction; the injected
        # stall rule needs for_s of flat samples at the 0.2 s cadence
        time.sleep(1.5)

        inc = _cli(env, "query", "--node", addr, "incidents")
        if inc.returncode != 0:
            print(f"incident-smoke: query incidents failed: {inc.stderr}",
                  file=sys.stderr)
            return 1
        listing = json.loads(inc.stdout)
        if not listing.get("enabled") or not listing.get("incidents"):
            print(
                f"incident-smoke: no incident captured ({inc.stdout[:300]})",
                file=sys.stderr,
            )
            return 1
        newest = listing["incidents"][-1]
        if STALL_RULE["name"] not in newest.get("reason", ""):
            print(
                f"incident-smoke: wrong trigger: {newest.get('reason')!r}",
                file=sys.stderr,
            )
            return 1

        out_dir = os.path.join(base, "fetched")
        fetched = _cli(
            env, "query", "--node", addr, "incident",
            "--id", newest["id"], "--out", out_dir,
        )
        if fetched.returncode != 0:
            print(f"incident-smoke: query incident failed: {fetched.stderr}",
                  file=sys.stderr)
            return 1
        bundle_dir = os.path.join(out_dir, newest["id"])
        with open(os.path.join(bundle_dir, "manifest.json")) as f:
            manifest = json.load(f)
        problems = flight_mod.validate_manifest(manifest)
        if problems:
            print(f"incident-smoke: invalid manifest: {problems[:5]}",
                  file=sys.stderr)
            return 1
        with open(os.path.join(bundle_dir, "trace.json")) as f:
            trace = json.load(f)
        problems = tracing.validate_chrome_trace(trace)
        if problems:
            print(f"incident-smoke: invalid bundle trace: {problems[:5]}",
                  file=sys.stderr)
            return 1
        samples = [
            ev for ev in trace["traceEvents"] if ev.get("cat") == "sample"
        ]
        if not samples:
            print("incident-smoke: bundle trace has no cat=sample events",
                  file=sys.stderr)
            return 1
        tracks = {
            ev["tid"]: ev["args"]["name"]
            for ev in trace["traceEvents"]
            if ev.get("ph") == "M" and ev.get("name") == "thread_name"
        }
        bad = [
            ev["tid"] for ev in samples
            if not tracks.get(ev["tid"])
            or tracks[ev["tid"]].startswith("device:")
        ]
        if bad:
            print(
                f"incident-smoke: samples on unnamed/device tracks: {bad[:3]}",
                file=sys.stderr,
            )
            return 1
        with open(os.path.join(bundle_dir, "stacks.folded")) as f:
            folded = f.read()
        if not folded.strip():
            print("incident-smoke: bundle folded stacks are empty",
                  file=sys.stderr)
            return 1

        prof = _cli(env, "query", "--node", addr, "host-profile")
        if prof.returncode != 0:
            print(f"incident-smoke: query host-profile failed: {prof.stderr}",
                  file=sys.stderr)
            return 1
        prof_doc = json.loads(prof.stdout)
        if not prof_doc["stats"]["enabled"] or (
            prof_doc["stats"]["samples_total"] < 1
        ):
            print(f"incident-smoke: profiler not live: {prof_doc['stats']}",
                  file=sys.stderr)
            return 1

        hz_doc = json.loads(urllib.request.urlopen(
            f"http://{http_addr}/healthz", timeout=30
        ).read().decode())
        if hz_doc.get("status") != "degraded" or (
            STALL_RULE["name"] not in hz_doc.get("alerts_firing", [])
        ):
            print(f"incident-smoke: healthz did not degrade: {hz_doc}",
                  file=sys.stderr)
            return 1

        print(json.dumps({
            "incident_smoke": "ok",
            "device": device,
            "height": height,
            "node_counts": [_node_counts(addr)],
            "incident": newest["id"],
            "reason": newest["reason"],
            "sample_events": len(samples),
            "folded_lines": len(folded.strip().splitlines()),
            "healthz": hz_doc["status"],
        }))
        return 0
    finally:
        _stop_node(proc)


def leg2(device: str) -> int:
    # in-process half: the disarmed sampler surface must stay under 1%
    # of a 10k-iteration work loop (one bool check per call)
    from celestia_tpu_torch.utils import hostprof
    from celestia_tpu_torch.utils.telemetry import clock

    hostprof.stop()
    payload = b"\xcd" * 49152
    t0 = clock()
    for _ in range(10_000):
        hashlib.sha256(payload).digest()
    t_loop = clock() - t0
    t0 = clock()
    for _ in range(10_000):
        hostprof.sample_once()
    t_calls = clock() - t0
    ratio = t_calls / max(1e-9, t_loop)
    if ratio >= 0.01:
        print(
            f"incident-smoke: disarmed sampler cost {ratio * 100:.2f}% "
            f"of the 10k loop (calls {t_calls * 1e3:.2f} ms, work "
            f"{t_loop * 1e3:.1f} ms)",
            file=sys.stderr,
        )
        return 1

    # subprocess half: a node without the flags writes NOTHING
    base = tempfile.mkdtemp(prefix="incident-smoke-off-")
    env = _env(device, {"CELESTIA_TPU_TORCH_ALERT_RULES": json.dumps([STALL_RULE])})
    proc, home = _start_node(base, "disarmed", env, [])
    if proc is None:
        return 1
    try:
        line = tools.readline_deadline(proc)
        if line is None or proc.poll() is not None:
            why = "died" if proc.poll() is not None else "hung"
            print(f"incident-smoke: disarmed validator {why} at startup",
                  file=sys.stderr)
            return 1
        addr = json.loads(line)["grpc"]
        _produce_one_block(addr)
        time.sleep(1.0)  # the stall rule fires; nothing may be written
        inc = _cli(env, "query", "--node", addr, "incidents")
        listing = json.loads(inc.stdout)
        if listing.get("enabled") or listing.get("incidents"):
            print(f"incident-smoke: disarmed node captured: {inc.stdout}",
                  file=sys.stderr)
            return 1
        prof = json.loads(
            _cli(env, "query", "--node", addr, "host-profile").stdout
        )
        if prof["stats"]["enabled"] or prof["stats"]["samples_total"]:
            print(
                f"incident-smoke: disarmed node sampled: {prof['stats']}",
                file=sys.stderr,
            )
            return 1
        flight_dirs = [
            p for p in os.listdir(base)
            if "flight" in p
        ]
        if flight_dirs:
            print(f"incident-smoke: unexpected flight dirs: {flight_dirs}",
                  file=sys.stderr)
            return 1
        print(json.dumps({
            "incident_smoke_disarmed": "ok",
            "device": device,
            "node_counts": [_node_counts(addr)],
            "overhead_pct_of_loop": round(ratio * 100, 3),
            "incidents": 0,
        }))
        return 0
    finally:
        _stop_node(proc)


LEGS = {"armed": leg1, "disarmed": leg2}


def main(argv=None) -> int:
    return tools.run_legs("incident_smoke", LEGS, argv, __doc__)


if __name__ == "__main__":
    sys.exit(main())
