"""DAS light-client swarm harness: crowd-shaped load for the serving plane.

Extends client/txsim.py's pattern (deterministic per-actor rng, cloneable
workloads, one driver loop) from transactions to DATA-AVAILABILITY
SAMPLING: hundreds-to-thousands of simulated light clients with
zipf-distributed block/row interest, generation churn, mixed batch
sizes, and a configurable fraction of HOSTILE over-askers, driving a
live node over the real gRPC boundary (RemoteNode.das_sample_batch with
a client-asserted ``peer`` identity, so the server's per-peer QoS
accounting sees the crowd).

The report answers the questions the ROADMAP poses about planet-scale
serving: p50/p99 request latency per expected tier (``light`` = honest
population, ``hostile`` = the over-askers), client-observed shed rate,
cells/s, and the Jain fairness index over per-client served counts —
the client-side mirror of the numbers the server exposes per peer.
Everything is seeded (``SwarmConfig.seed``); wall-clock concurrency
makes shed *counts* load-dependent, so consumers assert on bounds and
distributions, never exact schedules.
"""

from __future__ import annotations

import threading
from concurrent import futures
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from celestia_tpu_torch.utils import faults
from celestia_tpu_torch.utils.telemetry import clock, jain_fairness_index


@dataclass
class SwarmConfig:
    """Shape of the crowd.  ``clients`` includes ``hostile`` over-askers
    (the first ``hostile`` indexes), who ask ``hostile_multiplier`` x the
    honest batch size every round.  ``churn`` replaces that fraction of
    the HONEST population with fresh identities between rounds (new
    generation suffix — the server sees genuinely new peers).
    ``deadline_s`` is a hard wall budget: the driver stops issuing new
    rounds once it is exceeded and reports ``deadline_hit`` instead of
    running forever (the bench leg's never-a-dead-round contract)."""

    clients: int = 64
    hostile: int = 8
    rounds: int = 3
    samples_per_round: int = 6
    hostile_multiplier: int = 8
    zipf_a: float = 1.3
    churn: float = 0.1
    batch_sizes: Tuple[int, ...] = (4, 8, 16)
    seed: int = 0
    workers: int = 8
    retry_attempts: int = 4
    request_deadline_s: float = 5.0
    deadline_s: float = 60.0


class SwarmClient:
    """One simulated light client: deterministic rng (txsim's
    ``seed * 1000 + i`` convention, widened with the churn generation),
    zipf block/row interest, and a stable asserted peer identity."""

    def __init__(
        self,
        index: int,
        generation: int,
        hostile: bool,
        blocks: List[Tuple[int, int]],
        cfg: SwarmConfig,
    ):
        self.index = index
        self.hostile = hostile
        tag = "hostile" if hostile else "swarm"
        self.peer_id = f"{tag}-g{generation}-{index:04d}"
        self.blocks = blocks
        self.cfg = cfg
        self.rng = np.random.default_rng(
            cfg.seed * 1000 + generation * 1_000_003 + index
        )

    def _zipf_index(self, n: int) -> int:
        # zipf rank (1-based, unbounded tail) clamped into [0, n): the
        # head blocks/rows soak most of the interest, like real crowds
        return min(int(self.rng.zipf(self.cfg.zipf_a)) - 1, n - 1)

    def pick_batch(self) -> Tuple[int, List[Tuple[int, int]]]:
        """(height, coords) for one sampling round — hostile clients
        over-ask by ``hostile_multiplier``."""
        height, k = self.blocks[self._zipf_index(len(self.blocks))]
        want = int(self.rng.choice(list(self.cfg.batch_sizes)))
        want *= self.cfg.samples_per_round
        if self.hostile:
            want *= self.cfg.hostile_multiplier
        side = 2 * k
        coords = []
        for _ in range(want):
            r = self._zipf_index(side)
            c = int(self.rng.integers(0, side))
            coords.append((r, c))
        return height, coords


def _percentiles(samples_ms: List[float]) -> Dict[str, float]:
    if not samples_ms:
        return {"count": 0, "p50_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0}
    arr = np.asarray(samples_ms, dtype=np.float64)
    return {
        "count": int(arr.size),
        "p50_ms": round(float(np.percentile(arr, 50)), 3),
        "p99_ms": round(float(np.percentile(arr, 99)), 3),
        "max_ms": round(float(arr.max()), 3),
    }


def run_swarm(
    address: str,
    blocks: List[Tuple[int, int]],
    cfg: Optional[SwarmConfig] = None,
    on_served: Optional[Callable[[int, List[Tuple[int, int]], dict], None]] = None,
) -> dict:
    """Drive a live node at ``address`` with the configured crowd.

    ``blocks`` is the sampleable universe: ``(height, square_size)``
    pairs (square_size = the ORIGINAL k; coordinates span the extended
    2k x 2k square).  Returns the swarm report described in the module
    docstring.  Client-side failures are per-request, never fatal — a
    saturated node yields a high shed rate, not an exception.
    ``on_served(height, coords, response)``, when given, sees every
    answered request's response (from the worker threads), so a caller
    can verify the served proofs; the reference has no such hook."""
    from celestia_tpu_torch.node.remote import RemoteNode

    cfg = cfg or SwarmConfig()
    if not blocks:
        raise ValueError("swarm needs at least one sampleable block")
    n_hostile = min(cfg.hostile, cfg.clients)
    population = [
        SwarmClient(i, 0, i < n_hostile, blocks, cfg)
        for i in range(cfg.clients)
    ]

    lock = threading.Lock()
    lat_ms: Dict[str, List[float]] = {"light": [], "hostile": []}
    served_by_peer: Dict[str, int] = {}
    totals = {"requests": 0, "failed": 0, "asked": 0, "served": 0}
    groups = {
        "light": {"requests": 0, "failed": 0, "served": 0},
        "hostile": {"requests": 0, "failed": 0, "served": 0},
    }
    remotes: List[RemoteNode] = []
    tls = threading.local()

    def _remote() -> RemoteNode:
        r = getattr(tls, "remote", None)
        if r is None:
            r = RemoteNode(address, timeout_s=cfg.request_deadline_s * 2)
            tls.remote = r
            with lock:
                remotes.append(r)
        return r

    def client_round(cl: SwarmClient) -> None:
        height, coords = cl.pick_batch()
        group = "hostile" if cl.hostile else "light"
        policy = faults.RetryPolicy(
            attempts=cfg.retry_attempts, base_s=0.01, cap_s=0.05,
            deadline_s=cfg.request_deadline_s,
            seed=cfg.seed * 7919 + cl.index,
        )
        t0 = clock()
        served = 0
        failed = 0
        try:
            out = _remote().das_sample_batch(
                height, coords, peer=cl.peer_id, policy=policy
            )
            served = len(out["proofs"])
            if on_served is not None:
                on_served(height, coords, out)
        except Exception as e:
            # a shed-to-exhaustion (faults.Overloaded) or transport
            # hiccup is DATA for the swarm — the request failed, the
            # crowd marches on; noted, never silently dropped
            faults.note("swarm.request", e)
            failed = 1
        ms = (clock() - t0) * 1000.0
        with lock:
            lat_ms[group].append(ms)
            totals["requests"] += 1
            totals["failed"] += failed
            totals["asked"] += len(coords)
            totals["served"] += served
            groups[group]["requests"] += 1
            groups[group]["failed"] += failed
            groups[group]["served"] += served
            served_by_peer[cl.peer_id] = (
                served_by_peer.get(cl.peer_id, 0) + served
            )

    t_start = clock()
    rounds_run = 0
    deadline_hit = False
    try:
        with futures.ThreadPoolExecutor(
            max_workers=max(1, cfg.workers)
        ) as pool:
            for rnd in range(cfg.rounds):
                if clock() - t_start > cfg.deadline_s:
                    deadline_hit = True
                    break
                list(pool.map(client_round, population))
                rounds_run += 1
                # churn: a slice of the honest population leaves and is
                # replaced by fresh identities (next generation)
                n_churn = int(cfg.churn * (cfg.clients - n_hostile))
                for j in range(n_churn):
                    idx = n_hostile + (
                        (rnd * n_churn + j) % max(1, cfg.clients - n_hostile)
                    )
                    population[idx] = SwarmClient(
                        idx, rnd + 1, False, blocks, cfg
                    )
    finally:
        for r in remotes:
            try:
                r.close()
            except Exception as e:
                faults.note("swarm.close", e)

    elapsed_s = max(1e-9, clock() - t_start)
    return {
        "clients": cfg.clients,
        "hostile": n_hostile,
        "rounds_run": rounds_run,
        "requests": totals["requests"],
        "failed": totals["failed"],
        "cells_asked": totals["asked"],
        "cells_served": totals["served"],
        "samples_per_s": round(totals["served"] / elapsed_s, 3),
        "shed_rate": round(
            totals["failed"] / max(1, totals["requests"]), 4
        ),
        "fairness_index": jain_fairness_index(served_by_peer.values()),
        "groups": {
            name: dict(
                st,
                shed_rate=round(st["failed"] / max(1, st["requests"]), 4),
            )
            for name, st in groups.items()
        },
        "latency": {
            group: _percentiles(samples)
            for group, samples in lat_ms.items()
        },
        "elapsed_s": round(elapsed_s, 3),
        "deadline_hit": deadline_hit,
    }
