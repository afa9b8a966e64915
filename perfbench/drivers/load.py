"""Back-to-back full loads of a CompBin file into HBM (``load`` mixes).

Each load is what a user of the paper's path runs: a new PG-Fuse mount
in the ``stream`` access mode (``core/policy.py::choose_access_mode``),
``repro_torch.data.stream_partitions(g, device)`` with every shard kept
resident until a ``torch.cuda.synchronize()``, then all released.  The
window runs loads until one finishes at or past ``--seconds``; the
loads of a seed-drawn residue class (every ``check_every``-th, and the
last if none fell in it) keep their shards until the window has closed,
and those are held to the generator's CSR, kept on the host, id for id.
Set-up prints the device peak of one load alone (the warm-up): what a
deployment holds, apart from the shards the check keeps.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.drivers.graph import GraphFile
from perfbench.reference import csr as ref_csr


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Cell:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 trace: bool):
        from repro_torch.core import policy
        self.device = device
        self.graph = GraphFile(cfg, seed, device, host_copy=True)
        self._amode = policy.choose_access_mode(traffic["access_mode"])
        self._every = int(traffic["check_every"])
        self._keep_at = int(np.random.default_rng(
            [int(seed) % (1 << 63), 1]).integers(self._every))
        self.kept: list = []
        self.stats: list = []
        self.attempted = self.failed = 0
        on_gpu = torch.device(device).type == "cuda"
        if on_gpu:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        self._load()          # builds K1 and warms the allocator
        peak = torch.cuda.max_memory_allocated(device) if on_gpu else 0
        print(f"setup: warm-up load in {time.perf_counter() - t0:.3f} s, "
              f"its device peak {peak} B", file=sys.stderr)

    def _load(self):
        from repro_torch.core.paragrapher import open_graph
        from repro_torch.data import stream_partitions
        with record_function("perfbench.load"):
            with open_graph(self.graph.path, use_pgfuse=True,
                            pgfuse_readahead=self._amode.readahead,
                            pgfuse_eviction=self._amode.eviction) as g:
                with stream_partitions(g, self.device) as stream:
                    shards = list(stream)
            _sync(self.device)
        return shards, stream.stats

    def run(self, seconds: float) -> dict:
        edges = 0
        t0 = time.perf_counter()
        while True:
            shards, st = self._load()
            done = time.perf_counter() - t0 >= seconds
            if (self.attempted % self._every == self._keep_at
                    or (done and not self.kept)):
                self.kept.append(shards)
            del shards
            self.attempted += 1
            self.stats.append(st)
            edges += st.edges
            if done:
                break
        self.window_s = time.perf_counter() - t0
        print("window: load seconds " + " ".join(
            f"{st.wall_s:.3f}" for st in self.stats), file=sys.stderr)
        return {"load_edges_per_s": edges / self.window_s}

    def release(self) -> None:
        pass

    def check(self) -> dict:
        g = self.graph
        bad = sum(ref_csr.shard_mismatches(s, g.host_offsets,
                                           g.host_neighbors)
                  for s in self.kept)
        return {"load_ids_wrong": (bad, 0)}

    def control(self) -> dict:
        """The control's numbers, as :meth:`check` gives the program's:
        the reference's shards of the kept loads with ids in ``b - 1``
        bytes."""
        g = self.graph
        bad = sum(ref_csr.shard_mismatches(
            ref_csr.control_shards(s, g.host_offsets, g.host_neighbors,
                                   g.b), g.host_offsets, g.host_neighbors)
            for s in self.kept)
        return {f"ids_in_{g.b - 1}_bytes": {"load_ids_wrong": (bad, 0)}}

    def context(self) -> dict:
        st = self.stats
        return {"loads": len(st),
                "edges": sum(s.edges for s in st),
                "b": self.graph.b,
                "decode_s": sum(s.decode_s for s in st),
                "wall_s": sum(s.wall_s for s in st),
                "bytes_h2d": sum(s.bytes_h2d for s in st)}

    def close(self) -> None:
        self.kept = []
        self.graph.close()
