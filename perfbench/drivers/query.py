"""Closed-loop neighbour queries through ``NeighborQueryEngine.submit``
(``query`` mixes).

Set-up mounts the CompBin file in the ``serve`` access mode with the
configuration's block size and resident budget, builds the engine with
its hot-set tier, and sends each client's warm-up requests.  In the
window every client thread sends a request, waits for its reply and
sends the next, until ``--seconds`` have passed; the requests still in
flight then finish.  Each request is timed on the client's side, from
``submit`` to its result; a request that raises is failed and counts as
missing the percentile.  The answers of a seed-drawn share of requests
are kept and held to the generator's CSR after the window.
"""

from __future__ import annotations

import math
import sys
import threading
import time

import torch

from perfbench.drivers.graph import GraphFile
from perfbench.gen import traffic as gen_traffic
from perfbench.reference import csr as ref_csr

#: seconds a client waits for one reply before counting it failed
REPLY_TIMEOUT_S = 120.0


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 trace: bool):
        from repro_torch.core import policy
        from repro_torch.core.paragrapher import open_graph
        from repro_torch.obs import Tracer
        from repro_torch.query import BYTES_PER_EDGE, NeighborQueryEngine

        self.seed = seed
        self.traffic = traffic
        self.graph = GraphFile(cfg, seed, device, host_copy=True)
        deg = self.graph.degrees
        self.hubs = gen_traffic.hub_ids(traffic, deg)
        hs = cfg["hotset"]
        hot_hubs = gen_traffic.top_degree(
            deg, max(16, int(deg.size * hs["hubs_per_vertex"])))
        self.hotset_bytes = max(
            int(hs["min_bytes"]),
            int(hs["hub_runs_factor"] * int(deg[hot_hubs].sum())
                * BYTES_PER_EDGE))
        pg = cfg["pgfuse"]
        amode = policy.choose_access_mode("serve")
        block = int(pg["serve_block_bytes"])
        self.tracer = Tracer(max_traces=1 << 22) if trace else None
        self.g = open_graph(
            self.graph.path, use_pgfuse=True, pgfuse_block_size=block,
            pgfuse_readahead=amode.readahead, pgfuse_eviction=amode.eviction,
            pgfuse_max_resident_bytes=max(
                64 * block, int(self.graph.file_bytes
                                * pg["serve_resident_share"])))
        eng = cfg["engine"]
        self.engine = NeighborQueryEngine(
            self.g, decode=eng["decode"], max_batch=int(eng["max_batch"]),
            hotset=self.hotset_bytes, device=device, tracer=self.tracer)
        self.records: list = []
        self.errors: list = []
        t0 = time.perf_counter()
        self._clients(lambda k: gen_traffic.Requests(
            traffic, self.graph.n_vertices, self.hubs, seed, k, phase=1),
            count=int(traffic["warmup_requests"]), sink=None)
        print(f"setup: warm-up requests in {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)
        if self.tracer is not None:
            self.tracer.drain()

    def _clients(self, make, *, count=None, stop_at=None, sink) -> None:
        """Run ``traffic["clients"]`` closed-loop clients until each has
        sent ``count`` requests or ``stop_at`` (host clock) has passed."""
        start = threading.Barrier(int(self.traffic["clients"]))
        lock = threading.Lock()

        def client(k: int) -> None:
            reqs = make(k)
            start.wait()
            sent = 0
            while (count is None or sent < count) and \
                    (stop_at is None or time.perf_counter() < stop_at):
                ids, keep = reqs.next()
                t0 = time.perf_counter()
                try:
                    res = self.engine.submit(ids).result(REPLY_TIMEOUT_S)
                    ok = True
                except Exception as e:  # a failed request is recorded
                    res, ok = None, False
                    with lock:
                        self.errors.append(repr(e))
                t1 = time.perf_counter()
                sent += 1
                if sink is not None:
                    rec = (t0, t1, ids.size, ok,
                           ids if keep else None, res if keep else None)
                    with lock:
                        sink.append(rec)

        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(int(self.traffic["clients"]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def run(self, seconds: float) -> dict:
        hs = self.engine.hotset.stats
        self._hot0 = (hs.hits, hs.lookups)
        tier0 = (hs.resident_bytes, hs.evicted)
        pg0 = self.g.pgfuse_stats()
        self._batches0 = self.engine.stats.batches
        t0 = time.perf_counter()
        t_end = t0 + seconds
        self._clients(lambda k: gen_traffic.Requests(
            self.traffic, self.graph.n_vertices, self.hubs, self.seed, k),
            stop_at=t_end, sink=self.records)
        self.window_s = seconds
        self._hot1 = (hs.hits, hs.lookups)
        self._batches1 = self.engine.stats.batches
        recs = self.records
        self.attempted = len(recs)
        self.failed = sum(1 for r in recs if not r[3])
        done_ids = sum(r[2] for r in recs if r[3] and r[1] <= t_end)
        lat = sorted(r[1] - r[0] if r[3] else math.inf for r in recs)
        p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)] if lat else math.inf
        thirds = [sum(r[2] for r in recs if r[3] and t0 + k * seconds / 3
                      < r[1] <= t0 + (k + 1) * seconds / 3) * 3 / seconds
                  for k in range(3)]
        print("window: vertices/s by third " + " ".join(
            f"{v:.1f}" for v in thirds), file=sys.stderr)
        by_s = [0] * math.ceil(seconds)
        for r in recs:
            if r[3] and r[1] <= t_end:
                by_s[min(len(by_s) - 1, int(r[1] - t0))] += r[2]
        print("window: vertices by second " + " ".join(map(str, by_s)),
              file=sys.stderr)
        print(f"window: hot-set tier of {self.engine.hotset.plan.budget_bytes}"
              f" B held {tier0[0]} -> {hs.resident_bytes} B, evicted "
              f"{hs.evicted - tier0[1]} entries", file=sys.stderr)
        pg1 = self.g.pgfuse_stats()
        print(f"window: PG-Fuse evictions {pg0.evictions} -> "
              f"{pg1.evictions}, misses {pg0.cache_misses} -> "
              f"{pg1.cache_misses}, hits {pg0.cache_hits} -> "
              f"{pg1.cache_hits}", file=sys.stderr)
        return {"query_vertices_per_s": done_ids / seconds,
                "query_p95_ms": p95 * 1e3}

    def release(self) -> None:
        self.engine.close()
        self.g.close()
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def _kept(self) -> list:
        """The records whose answers are held to the reference."""
        return [r for r in self.records if r[4] is not None and r[3]]

    def check(self) -> dict:
        g = self.graph
        kept = self._kept()
        bad = sum(ref_csr.answer_mismatches(r[4], r[5], g.host_offsets,
                                            g.host_neighbors) for r in kept)
        return {"requests_checked": (len(kept), 1, ">="),
                "query_ids_wrong": (bad, 0),
                "requests_failed": (self.failed, 0)}

    def control(self) -> dict:
        """The control's numbers, as :meth:`check` gives the program's:
        the reference's answers to the kept requests with ids in
        ``b - 1`` bytes."""
        g = self.graph
        bad = sum(ref_csr.answer_mismatches(
            r[4], ref_csr.control_answers(r[4], g.host_offsets,
                                          g.host_neighbors, g.b),
            g.host_offsets, g.host_neighbors) for r in self._kept())
        return {f"ids_in_{g.b - 1}_bytes": {"query_ids_wrong": (bad, 0)}}

    def context(self) -> dict:
        hits = self._hot1[0] - self._hot0[0]
        lookups = self._hot1[1] - self._hot0[1]
        return {"spans": self.tracer.drain() if self.tracer else [],
                "hotset_hits": hits, "hotset_lookups": lookups,
                "batches": self._batches1 - self._batches0}

    def close(self) -> None:
        self.graph.close()
