"""Client-tier re-export of the gRPC RemoteNode.

The implementation moved to node/remote.py (celint R8): the mesh is its
heaviest user — gossip links, catch-up pulls and state-sync fetches are
a node acting as an RPC client — and node/ may not import client/.
The wallet/CLI tier keeps importing it from here; this shim is the
whole public surface.
"""

from celestia_tpu_torch.node.remote import (  # noqa: F401
    RPC_TELEMETRY,
    RemoteError,
    RemoteNode,
    SERVICE,
    client_rpc_exposition,
)
