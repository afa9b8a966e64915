"""Closed-loop multi-client load generator on a virtual clock.

Admission control is only trustworthy if its two promises — admitted
requests keep the SLO, overload surfaces as shed rate — are *measured
under overload*, and overload measurements on a shared CI machine are
noise.  :class:`LoadGenerator` therefore replays a whole serving day as
a **deterministic discrete-event simulation**: virtual clients, virtual
servers, virtual time.  Nothing here sleeps or threads; given the same
seed, graph and config, every latency sample, shed decision and stats
counter is bit-for-bit reproducible — p50/p99 and shed rate become
CI-gateable numbers.

Model
-----

* **Closed loop**: each of ``n_clients`` clients has at most one
  request outstanding — submit, wait for the answer, think for
  ``think_s``, submit again.  A shed request is retried after
  ``backoff_s``.  Closed loops self-throttle (offered load scales with
  completion rate), which is exactly how real SDK clients behave and
  why shedding, not queue collapse, is the visible overload signal.
* **Service time** is charged by an explicit cost model,
  ``cost_fn(result) -> seconds`` (default:
  :data:`HOP_DISPATCH_S` per frontier batch +
  ``edges_scanned / EDGES_PER_S``), plus whatever the storage layer's
  virtual clock charged during the traversal (pass ``charged_s=`` a
  callable reading it, e.g. ``lambda: sim_storage.charged_s``).
* **Concurrency** is ``plan.servers`` virtual executor slots: an
  admitted request starts on the earliest-free slot (FIFO) and
  finishes ``cost`` later; its latency is ``finish - arrival`` —
  queueing delay included, which is what the admission gate's sizing
  bounds.
* **Admission** drives the REAL :class:`~repro_torch.query.traversal
  .TraversalService` gate and stats: the generator calls
  ``service.admit`` at (virtual) arrival and ``service.complete`` at
  (virtual) finish, so gate occupancy on the virtual timeline is
  exactly what a threaded deployment would see, and the conservation
  invariants (``admitted + shed == submitted``) are asserted on the
  service's own counters.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, List, Optional

import numpy as np

from repro_torch.query.traversal import (TraversalRequest, TraversalService)

#: default deterministic service-cost model: per-frontier dispatch +
#: per-edge scan cost (rates in the ballpark of the query bench's
#: decode model; the ratios are what load tests exercise)
HOP_DISPATCH_S = 100e-6
EDGES_PER_S = 5.0e6


def default_cost_fn(result) -> float:
    """Virtual seconds of service a finished traversal consumed."""
    return HOP_DISPATCH_S * max(1, result.hops) \
        + result.edges_scanned / EDGES_PER_S


@dataclasses.dataclass
class LoadReport:
    """One simulated run's outcome (all virtual-clock derived)."""

    horizon_s: float
    n_clients: int
    submitted: int = 0
    admitted: int = 0
    shed: int = 0
    completed: int = 0
    failed: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)
    errors: list = dataclasses.field(default_factory=list)

    @property
    def shed_rate(self) -> float:
        return self.shed / self.submitted if self.submitted else 0.0

    def latency_quantile(self, q: float) -> float:
        if not self.latencies_s:
            return 0.0
        return float(np.quantile(np.asarray(self.latencies_s), q))

    @property
    def p50_s(self) -> float:
        return self.latency_quantile(0.50)

    @property
    def p99_s(self) -> float:
        return self.latency_quantile(0.99)

    @property
    def throughput_rps(self) -> float:
        return self.completed / self.horizon_s if self.horizon_s else 0.0

    def as_dict(self) -> dict:
        return {
            "horizon_s": self.horizon_s, "n_clients": self.n_clients,
            "submitted": self.submitted, "admitted": self.admitted,
            "shed": self.shed, "completed": self.completed,
            "failed": self.failed, "shed_rate": self.shed_rate,
            "p50_s": self.p50_s, "p99_s": self.p99_s,
            "throughput_rps": self.throughput_rps,
            "n_errors": len(self.errors),
        }


class LoadGenerator:
    """Deterministic closed-loop load over a
    :class:`~repro_torch.query.traversal.TraversalService`.

    ``make_request(rng, client_id) -> TraversalRequest`` shapes the
    traffic (each client owns a ``np.random.default_rng(seed + id)``,
    so traces are reproducible per client, independent of event
    interleaving).  ``run()`` simulates until ``horizon_s`` of virtual
    time, drains in-flight requests, and returns a
    :class:`LoadReport`.
    """

    def __init__(self, service: TraversalService,
                 make_request: Callable[[np.random.Generator, int],
                                        TraversalRequest], *,
                 n_clients: int, horizon_s: float,
                 think_s: float = 0.0, backoff_s: float = 0.01,
                 cost_fn: Callable = default_cost_fn,
                 charged_s: Optional[Callable[[], float]] = None,
                 servers: Optional[int] = None,
                 seed: int = 0):
        if n_clients < 1 or horizon_s <= 0:
            raise ValueError("n_clients must be >= 1 and horizon_s > 0")
        if think_s < 0 or backoff_s < 0:
            raise ValueError("think_s and backoff_s must be >= 0")
        self.service = service
        self.make_request = make_request
        self.n_clients = int(n_clients)
        self.horizon_s = float(horizon_s)
        self.think_s = float(think_s)
        self.backoff_s = float(backoff_s)
        self.cost_fn = cost_fn
        self.charged_s = charged_s
        self.seed = int(seed)
        # executor slots: by default the admission plan's sizing; a
        # sharded deployment passes servers=plan.servers * n_shards so
        # the virtual executors match the scaled-out admission gate
        # (see docs/sharded_serving.md)
        if servers is not None and servers < 1:
            raise ValueError(f"servers must be >= 1, got {servers}")
        self.servers = (int(servers) if servers is not None
                        else (service.plan.servers if service.plan else 1))

    def run(self) -> LoadReport:
        report = LoadReport(horizon_s=self.horizon_s,
                            n_clients=self.n_clients)
        rngs = [np.random.default_rng(self.seed + c)
                for c in range(self.n_clients)]
        # event heap: (time, seq, kind, client, payload); seq breaks
        # ties deterministically (FIFO among simultaneous events)
        seq = 0
        heap: list = []
        self._server_free: List[float] = [0.0] * self.servers
        # stagger client starts across one think interval so "all
        # clients arrive at t=0" does not shed half the fleet on the
        # first tick by construction
        stagger = self.think_s / self.n_clients if self.think_s else 0.0
        for c in range(self.n_clients):
            heapq.heappush(heap, (c * stagger, seq, "submit", c, None))
            seq += 1
        svc = self.service
        while heap:
            t, _, kind, c, payload = heapq.heappop(heap)
            if kind == "finish":
                # the request virtually finishes NOW: release the gate,
                # fold the queue-inclusive latency, wake the client
                req, latency = payload
                svc.complete(req, latency)
                report.completed += 1
                report.latencies_s.append(latency)
                nxt = t + self.think_s
                if nxt <= self.horizon_s:
                    heapq.heappush(heap, (nxt, seq, "submit", c, None))
                    seq += 1
                continue
            if t > self.horizon_s:     # the client retires
                continue
            req = self.make_request(rngs[c], c)
            report.submitted += 1
            if not svc.admit(req):
                report.shed += 1
                heapq.heappush(
                    heap, (t + self.backoff_s, seq, "submit", c, None))
                seq += 1
                continue
            report.admitted += 1
            # execute the traversal NOW (results are time-independent);
            # place its virtual cost on the earliest-free server slot
            c0 = self.charged_s() if self.charged_s else 0.0
            try:
                res = svc.perform(req)
            except Exception as e:   # clean per-request failure
                report.failed += 1
                report.errors.append(e)
                nxt = t + self.backoff_s
                if nxt <= self.horizon_s:
                    heapq.heappush(heap, (nxt, seq, "submit", c, None))
                    seq += 1
                continue
            cost = self.cost_fn(res) + \
                ((self.charged_s() - c0) if self.charged_s else 0.0)
            free = heapq.heappop(self._server_free)
            start = max(t, free)
            finish = start + cost
            heapq.heappush(self._server_free, finish)
            heapq.heappush(heap, (finish, seq, "finish", c,
                                  (req, finish - t)))
            seq += 1
        return report
