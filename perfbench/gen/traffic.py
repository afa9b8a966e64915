"""The one request generator every query traffic mix is read by.

A mix is a JSON file of parameters under ``perfbench/traffic/``:

``clients``          closed-loop client threads (each waits for its reply)
``ids_per_request``  vertex ids in one request
``hub_share``        share of a request's ids drawn from the hubs
``hubs_per_vertex``  hubs = the top-degree ``|V| * hubs_per_vertex``
                     vertices (Graph500 / web request popularity tracks
                     degree)
``check_share``      share of requests whose answers are kept and held
                     to the reference after the window
``warmup_requests``  requests each client sends during set-up

The rest of an id draw is uniform over ``[0, |V|)``.  A rewrite of
``chip_smoke.py::hotset_trace`` / ``benchmarks/hotset.py``'s degree
trace in numpy, per request and per client: client ``k`` of seed ``s``
draws from ``default_rng([s, k, phase])``, so the same seed sends the
same requests, whatever order they reach the engine in.
"""

from __future__ import annotations

import numpy as np


def top_degree(degrees: np.ndarray, count: int) -> np.ndarray:
    """Ids of the ``count`` largest degrees (ties to the lower id)."""
    order = np.lexsort((np.arange(degrees.size), -degrees))
    return order[:max(1, count)].astype(np.int64)


def hub_ids(traffic: dict, degrees: np.ndarray) -> np.ndarray:
    n = degrees.size
    return top_degree(degrees, max(16, int(n * traffic["hubs_per_vertex"])))


class Requests:
    """The requests one client sends: ``next()`` gives ``(ids, keep)``,
    ``keep`` saying whether the answer is held to the reference."""

    def __init__(self, traffic: dict, n_vertices: int, hubs: np.ndarray,
                 seed: int, client: int, phase: int = 0):
        self._rng = np.random.default_rng([int(seed) % (1 << 63), client,
                                           phase])
        self._n = n_vertices
        self._hubs = hubs
        self._k = int(traffic["ids_per_request"])
        self._hub_share = float(traffic["hub_share"])
        self._check = float(traffic["check_share"])

    def next(self) -> tuple[np.ndarray, bool]:
        k, rng = self._k, self._rng
        ids = rng.integers(0, self._n, k)
        if self._hub_share > 0:
            hot = self._hubs[rng.integers(0, self._hubs.size, k)]
            ids = np.where(rng.random(k) < self._hub_share, hot, ids)
        return ids.astype(np.int64), bool(rng.random() < self._check)
