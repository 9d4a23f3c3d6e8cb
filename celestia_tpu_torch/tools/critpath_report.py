"""critpath-report: human-readable block-lifecycle latency report.

Twin of ``tools/critpath_report.py`` over the port's ``node/cluster.py``
and ``utils/critpath.py``.  It reads a trace file or asks live nodes for
theirs, and touches no device, so it takes no ``--device``:

    python -m celestia_tpu_torch.tools.critpath_report --trace FILE [--json]

Renders the per-height mesh waterfall (node/cluster.mesh_waterfall) and
the critical-path attribution (utils/critpath.critical_path) from
either

* ``--trace FILE`` — a merged Chrome doc written by
  ``query cluster-trace --out`` (or any single-node ``trace-dump``), or
* ``--nodes a,b,...`` — a live mesh: fans TraceDump + clock probes out,
  merges, and reports on the fresh doc.

The waterfall names the slowest validator per height and shows each
validator's propagation hop (clamped at 0 on clock skew); the critical
path section prints the blocking chain root→commit with every segment
attributed to self / queue-wait / flow / gap.  ``--json`` emits the raw
report objects instead of text.
"""

import argparse
import json
import os
import sys


def _bar(ms: float, scale_ms: float, width: int = 30) -> str:
    if scale_ms <= 0:
        return ""
    n = max(0, min(width, round(width * ms / scale_ms)))
    return "#" * n


def render_waterfall(wf: dict, out) -> None:
    for row in wf.get("heights", []):
        print(f"height {row['height']}", file=out)
        prop = row.get("proposer")
        ends = [v["end_ms"] for v in row["validators"]] or [0.0]
        scale = max([prop["prepare_ms"] if prop else 0.0] + ends)
        if prop:
            print(
                f"  proposer  {prop['node']:<24} prepare "
                f"{prop['prepare_ms']:>9.3f} ms  "
                f"|{_bar(prop['prepare_ms'], scale)}",
                file=out,
            )
        for v in row["validators"]:
            hop = v.get("propagation_ms")
            hop_s = (
                f" hop {hop:>7.3f} ms" + (" (clamped)" if v.get("clamped") else "")
                if hop is not None
                else ""
            )
            pad = " " * max(0, round(30 * v["start_ms"] / scale)) if scale else ""
            print(
                f"  validator {v['node']:<24} process "
                f"{v['process_ms']:>9.3f} ms{hop_s}  "
                f"|{pad}{_bar(v['process_ms'], scale)}",
                file=out,
            )
        spread = row.get("propagation_spread_ms")
        if spread is not None:
            print(f"  propagation spread: {spread:.3f} ms", file=out)
        if row.get("slowest_validator"):
            print(f"  slowest validator:  {row['slowest_validator']}", file=out)


def render_critpath(report: dict, out) -> None:
    root = report.get("root")
    if not root:
        print("no block root found in the trace", file=out)
        return
    end = report["end"]
    print(
        f"critical path: {root['name']}@{root['node'] or 'local'} -> "
        f"{end['name']}@{end['node'] or 'local'}  "
        f"({report['total_ms']:.3f} ms analyzed, root wall "
        f"{report['root_wall_ms']:.3f} ms)",
        file=out,
    )
    attr = report["attribution_ms"]
    print(
        "  attribution: "
        + "  ".join(f"{k}={attr[k]:.3f}ms" for k in ("self", "queue_wait", "flow", "gap")),
        file=out,
    )
    for g, ms in report.get("gap_by_phase_ms", {}).items():
        print(f"    gap[{g}] = {ms:.3f} ms", file=out)
    for st in report["steps"]:
        where = f"@{st['node']}" if st["node"] else ""
        print(
            f"  {st['t0_ms']:>10.3f} .. {st['t1_ms']:>10.3f}  "
            f"{st['kind']:<10} {st['name']}{where}  {st['ms']:.3f} ms",
            file=out,
        )
    if report.get("propagation"):
        for hop in report["propagation"]:
            clamp = " (clamped)" if hop["clamped"] else ""
            print(
                f"  hop {hop['from_node']} -> {hop['to_node']} "
                f"({hop['name']}): {hop['delay_ms']:.3f} ms{clamp}",
                file=out,
            )
    if report.get("commit_lag_ms") is not None:
        print(f"  commit lag: {report['commit_lag_ms']:.3f} ms", file=out)
    print(
        "  top contributors: "
        + ", ".join(
            f"{c['name']}[{c['kind']}]={c['ms']:.3f}ms"
            for c in report["top_contributors"]
        ),
        file=out,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--trace", help="merged (or single-node) Chrome trace JSON file")
    src.add_argument("--nodes", help="comma-separated live node addresses")
    ap.add_argument("--height", type=int, default=None, help="restrict to one height")
    ap.add_argument("--last", type=int, default=None, help="last N blocks per node (live)")
    ap.add_argument("--probes", type=int, default=5, help="clock probes per node (live)")
    ap.add_argument("--json", action="store_true", help="emit raw JSON reports")
    args = ap.parse_args(argv)

    from celestia_tpu_torch.node import cluster
    from celestia_tpu_torch.utils import critpath

    if args.trace:
        with open(args.trace) as f:
            doc = json.load(f)
    else:
        from celestia_tpu_torch.client.remote import RemoteNode

        clients = [
            RemoteNode(a.strip(), timeout_s=60.0)
            for a in args.nodes.split(",")
            if a.strip()
        ]
        try:
            doc = cluster.cluster_trace(
                clients, last=args.last, probes=args.probes
            )
        finally:
            for c in clients:
                c.close()

    wf = cluster.mesh_waterfall(doc, height=args.height)
    report = critpath.critical_path(doc, height=args.height)
    if args.json:
        print(json.dumps({"waterfall": wf, "critical_path": report}, indent=2))
        return 0
    render_waterfall(wf, sys.stdout)
    print()
    render_critpath(report, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
