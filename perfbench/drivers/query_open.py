"""Open-loop neighbour queries through ``NeighborQueryEngine.submit``
(``query_open`` mixes).

Set-up is the closed-loop cell's (``drivers/query.py``: the graph, the
``serve`` mount, the engine with its hot-set tier, the warm-up requests
of ``clients`` closed-loop clients).  In the window one thread submits
requests at the arrivals of a Poisson process of ``rate_per_s``, drawn
from the seed, whether or not earlier requests have finished; a second
thread takes their results in the order they were sent (the engine
answers its micro-batches in arrival order).  A request is timed from
its *scheduled* arrival to its result, so a submitter that falls behind
counts against the tail as a late request would; a request that raises
is failed and counts as missing the percentile.  Arrivals stop at the
end of the window and the requests in flight then finish; the vertices
per second count the requests answered inside the window.  Answers of a
seed-drawn share of requests are held to the generator's CSR.
"""

from __future__ import annotations

import math
import queue
import sys
import threading
import time

import numpy as np

from perfbench.drivers import query
from perfbench.gen import traffic as gen_traffic


class Cell(query.Cell):
    def run(self, seconds: float) -> dict:
        rate = float(self.traffic["rate_per_s"])
        hs = self.engine.hotset.stats
        self._hot0 = (hs.hits, hs.lookups)
        self._batches0 = self.engine.stats.batches
        reqs = gen_traffic.Requests(self.traffic, self.graph.n_vertices,
                                    self.hubs, self.seed, 0)
        gaps = np.random.default_rng([int(self.seed) % (1 << 63), 0, 2])
        sent: queue.Queue = queue.Queue()
        recs = self.records

        def collect() -> None:
            while True:
                item = sent.get()
                if item is None:
                    return
                t_sched, ids, keep, fut = item
                try:
                    if fut is None:
                        raise RuntimeError("submit failed")
                    res, ok = fut.result(query.REPLY_TIMEOUT_S), True
                except Exception as e:  # a failed request is recorded
                    res, ok = None, False
                    self.errors.append(repr(e))
                recs.append((t_sched, time.perf_counter(), ids.size, ok,
                             ids if keep else None, res if keep else None))

        collector = threading.Thread(target=collect, daemon=True)
        collector.start()
        late = 0.0
        t0 = time.perf_counter()
        t_end = t0 + seconds
        t_next = t0 + gaps.exponential(1.0 / rate)
        while t_next < t_end:
            wait = t_next - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late = max(late, time.perf_counter() - t_next)
            ids, keep = reqs.next()
            try:
                fut = self.engine.submit(ids)
            except Exception as e:  # counted failed by the collector
                fut = None
                self.errors.append(repr(e))
            sent.put((t_next, ids, keep, fut))
            t_next += gaps.exponential(1.0 / rate)
        sent.put(None)
        collector.join()
        self.window_s = seconds
        self._hot1 = (hs.hits, hs.lookups)
        self._batches1 = self.engine.stats.batches
        self.attempted = len(recs)
        self.failed = sum(1 for r in recs if not r[3])
        done_ids = sum(r[2] for r in recs if r[3] and r[1] <= t_end)
        lat = sorted(r[1] - r[0] if r[3] else math.inf for r in recs)
        p95 = lat[max(0, math.ceil(0.95 * len(lat)) - 1)] if lat else math.inf
        p50 = lat[max(0, math.ceil(0.5 * len(lat)) - 1)] if lat else math.inf
        by_s = [0] * math.ceil(seconds)
        for r in recs:
            if r[3] and r[1] <= t_end:
                by_s[min(len(by_s) - 1, int(r[1] - t0))] += r[2]
        print("window: vertices by second " + " ".join(map(str, by_s)),
              file=sys.stderr)
        print(f"window: offered {rate:.3f} requests/s, sent "
              f"{len(recs) / seconds:.3f}, answered "
              f"{done_ids / seconds:.1f} vertices/s; p50 {p50 * 1e3:.1f} ms,"
              f" p95 {p95 * 1e3:.1f} ms; submitter at most "
              f"{late * 1e3:.1f} ms late; "
              f"{self._batches1 - self._batches0} batches", file=sys.stderr)
        return {"query_vertices_per_s": done_ids / seconds,
                "query_p95_ms": p95 * 1e3}
