"""Set-up shared by the graph cells: the Graph500 graph drawn on the card
from the seed, written as CompBin for the program to read, and kept as
the reference CSR."""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from perfbench.gen import compbin, kronecker


class GraphFile:
    """The seed's graph: the CSR (``offsets`` / ``neighbors`` on the
    device, or with ``host_copy`` ``host_offsets`` / ``host_neighbors``
    and ``degrees`` on the host alone), the CompBin file at ``path`` (in
    a directory of its own under ``TMPDIR``, removed by :meth:`close`),
    ``b`` its bytes an id."""

    def __init__(self, cfg: dict, seed: int, device, *, host_copy: bool):
        t0 = time.perf_counter()
        self.offsets, self.neighbors = kronecker.graph500_csr(
            cfg["scale"], cfg["edge_factor"], seed, device,
            structure_seed=cfg["structure_seed"])
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        self.n_vertices = self.offsets.numel() - 1
        self.n_edges = self.neighbors.numel()
        self.b = compbin.bytes_per_id(self.n_vertices)
        self._dir = tempfile.mkdtemp(prefix="perfbench-")
        self.path = os.path.join(self._dir, f"{cfg['name']}.cbin")
        compbin.write(self.path, self.offsets, self.neighbors)
        self.file_bytes = os.path.getsize(self.path)
        self.degrees = None
        self.host_offsets = self.host_neighbors = None
        if host_copy:
            # the reference lives on the host; the card keeps nothing
            self.host_offsets = self.offsets.cpu().numpy()
            self.host_neighbors = self.neighbors.cpu().numpy()
            self.degrees = np.diff(self.host_offsets)
            self.offsets = self.neighbors = None
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
        print(f"setup: graph of {self.n_edges} edges drawn in {t1 - t0:.3f}"
              f" s, {self.file_bytes} B written in "
              f"{time.perf_counter() - t1:.3f} s", file=sys.stderr)

    def close(self) -> None:
        shutil.rmtree(self._dir, ignore_errors=True)
