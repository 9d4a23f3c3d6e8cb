"""trace_merge: fold N nodes' TraceDump outputs into one Perfetto timeline.

Twin of ``tools/trace_merge.py`` over the port's ``node/cluster.py``.  It
reads JSON files and touches no device, so it takes no ``--device``.

Usage:
    python -m celestia_tpu_torch.tools.trace_merge NODE1.json NODE2.json ... -o merged.json

Each input file is any of:
  * a ``collect_trace`` part: {"node_id", "clock_offset_s", "trace"},
  * a raw TraceDump RPC response: {"enabled", "blocks", "trace"},
  * a bare Chrome trace document (tracing.trace_dump() output).

The merge gives every node its own Chrome "process" (named by node id),
shifts each node's timestamps by its recorded clock offset, and resolves
every span that carries explicit cross-node parent args
(``remote_node``/``remote_span``) into a Chrome flow arrow from the
sender's span to the receiver's.  The output opens unchanged in
Perfetto (ui.perfetto.dev) / chrome://tracing.

Exit 0 with a summary JSON line on success; non-zero with the reason on
unreadable inputs or a schema-invalid merge.  Merge semantics:
specs/observability.md "Distributed tracing".
"""

import argparse
import json
import os
import sys



def load_part(path: str) -> dict:
    """Normalize one input file into the merge part shape."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: not a JSON object")
    if "trace" in doc and isinstance(doc["trace"], dict):
        # collect_trace part or TraceDump RPC response
        return {
            "node_id": doc.get("node_id", ""),
            "clock_offset_s": doc.get("clock_offset_s", 0.0),
            "rtt_s": doc.get("rtt_s", 0.0),
            "trace": doc["trace"],
        }
    if "traceEvents" in doc:
        # bare Chrome document: node id from its otherData when present
        return {
            "node_id": doc.get("otherData", {}).get("node_id", ""),
            "clock_offset_s": 0.0,
            "trace": doc,
        }
    raise ValueError(f"{path}: neither a trace part nor a Chrome document")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="trace_merge")
    p.add_argument("inputs", nargs="+", help="per-node trace JSON files")
    p.add_argument("-o", "--out", default="cluster.trace.json")
    args = p.parse_args(argv)

    from celestia_tpu_torch.node.cluster import merge_node_dumps
    from celestia_tpu_torch.utils.tracing import validate_chrome_trace

    try:
        parts = [load_part(path) for path in args.inputs]
    except (OSError, ValueError) as e:
        print(f"trace_merge: {e}", file=sys.stderr)
        return 1
    merged = merge_node_dumps(parts)
    problems = validate_chrome_trace(merged)
    if problems:
        print(f"trace_merge: invalid merged trace: {problems[:5]}",
              file=sys.stderr)
        return 1
    with open(args.out, "w") as f:
        json.dump(merged, f)
    print(
        json.dumps(
            {
                "merged": args.out,
                "nodes": [n["node_id"] for n in merged["otherData"]["nodes"]],
                "events": len(merged["traceEvents"]),
                "cross_node_flows": merged["otherData"]["cross_node_flows"],
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
