#!/usr/bin/env python3
"""On-GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py            # full size (load phase at --scale 22)

It builds every CUDA kernel from ``src/repro_torch/csrc`` with ``nvcc``,
holds each kernel against its plain PyTorch version on the card (the
decode bit for bit; the segment sum's two designs -- rows, atomic -- to
f32 rounding on the JAX sweep's shapes and nine id layouts, and rows
bit for bit to itself on the served ids; the segment sum's backward, a
gather, bit for bit on the same cases at every vector width the layout
allows; flash attention's three
designs -- tensor-core prefill, split decode, f32 FMA -- to the JAX
package's kernel tolerances),
drives the port's main paths through the library entry points -- load
a CompBin graph into HBM through PG-Fuse, answer batches of neighbor
queries from the same file, replay a hub-heavy trace through a cold
engine and one with the device-resident hot-set tier, serve k-hop / BFS /
shortest-path traversals on one engine and on 2 shards x 2 replicas
(answers held to a plain numpy traversal), serve GCN inference requests at gcn-cora's
full width (sample through the query engine, gather feature rows from
the feature store, one transfer, forward pass with the segment-sum
kernel), and serve
smollm-360m at full width and depth (prefill + greedy decode against a
KV cache, every attention on the flash-attention kernel; then again in
bf16 with every attention call held to f64), train gcn-cora at full
width (the full graph streamed by two simulated hosts, K2's forward and
its backward kernel, AdamW, a restart from a checkpoint after an injected
failure, the first step held to the plain path; then sampled minibatches
through the query engine; then both K2 designs and K2's backward timed at
the training shapes), serve and train PNA and train MeshGraphNet and
DimeNet at full width (``[gnn2]``: every segment sum on K2, every
gradient of one on its backward; then both timed at those models'
shapes), serve qwen2-moe-a2.7b at full width and depth and dbrx-132b at
full width on 6 of its 40 layers (``[moe]``: every attention call on
K3, every combine on K2, each model first held in f32 at 2 layers to
the plain path, routing as integers), train smollm-360m at full width
and qwen2-moe-a2.7b at full width on 2 layers (``[lm_train]``: the MoE
combine's gradient on K2's backward, a restart, the first step held to
the plain path), time K2, its backward and K3 at the MoE shapes, serve,
score and train DIN at full width over a 10M-item catalog (``[din]``:
``serve_din``, the same requests CompBin-packed and decoded on the card
by K1, a bulk batch, retrieval of one user against 262,144 candidates,
10 AdamW steps with a restart and 3 with ``--compress-grads`` on a
world-size-1 NCCL group; every logit held to the plain CPU path),
dry-run ``build_cell``'s 40 cells and 3 variants on the card's mesh and
run one step of each whose peak estimate fits the card (``[cells]``:
outputs held to the abstract trace's, the small GNN cells' first step to
the plain path, packed edges decoded by K1, a 32k-token prefill's
sampled attention rows to float64), run the four examples of
``examples/*_torch.py`` in this process at their own sizes
(``[examples]``: the quickstart's streamed CSR equal to the generated
one at rmat(20, 16), the GNN example's first steps held to the plain
path and its loss falling, DIN's first request held to the plain CPU
path, lm-100m as the example draws it and from its attention's true
fan-in, the latter's first step held to float64 and its loss falling
below ln(vocab)), and compile the load file with the graph
compiler and serve the hot-set trace from the compiled file -- checks
every result against an independent plain computation, and prints what
it measured.

Output contract: the line before the last but one is the card's name and
power limit as ``nvidia-smi`` gives them; the last but one is one JSON
object ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed phase raises, so the exit code is non-zero and no result line
is printed.  Without a CUDA device it exits with code 2 at once.

The load/serve/LogCSR/hot-set/traversal/GNN/train/gnn2/compile phases
are plain functions of ``device`` and ``scale``, the LM phases of ``(device, cfg, batch, prompt_len,
n_tokens)``, ``[moe]``, ``[lm_train]`` and ``[din]`` of ``device`` with
a ``reduced`` switch, ``[cells]`` of ``device`` and a cell list,
``[examples]`` of ``device`` and a list of runs, so the
CPU tests run the same code at a small size.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import inspect
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, NamedTuple, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(_HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import policy  # noqa: E402
from repro_torch.core.paragrapher import open_graph, save_graph  # noqa: E402
from repro_torch.data import assemble_csr, stream_partitions  # noqa: E402
from repro_torch.graph import rmat  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.obs import Tracer, tier_times  # noqa: E402
from repro_torch.kernels.compbin_decode import (compbin_decode,  # noqa: E402
                                                compbin_decode_ref,
                                                stream_bucket_ids)
from repro_torch.optim.adamw import (adamw_update, tree_leaves,  # noqa: E402
                                     tree_map, tree_unflatten)
from repro_torch.kernels.flash_attention import (attention_bshd,  # noqa: E402
                                                 attention_ref,
                                                 flash_attention, plan)
from repro_torch.kernels.segment_sum import plan as k2_plan  # noqa: E402
from repro_torch.kernels.segment_sum import (  # noqa: E402
    segment_sum, segment_sum_backward, segment_sum_grad_ref, segment_sum_ref)
from repro_torch.kernels.segment_sum.ops import (  # noqa: E402
    DESIGNS as K2_DESIGNS, GRAD_VECS, _segment_sum_backward_vec,
    _segment_sum_design, grad_vector_width)
from repro_torch.query import NeighborQueryEngine  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet): the roofline the
# kernels' bounds are stated against.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # non-tensor-core rate, used for integer ALU work
BF16_OPS_PER_S = 989e12         # dense bf16 tensor-core rate

SERVE_BLOCK_SIZE = 1 << 16      # PG-Fuse block for the random-access mount
TPU_KERNEL = "src/repro/kernels/compbin_decode/kernel.py:53"
CUDA_SOURCE = "src/repro_torch/csrc/compbin_decode.cu"
K2_TPU_KERNEL = "src/repro/kernels/segment_sum/kernel.py:57"
K2_CUDA_SOURCE = "src/repro_torch/csrc/segment_sum.cu"
K3_TPU_KERNEL = "src/repro/kernels/flash_attention/kernel.py:96"
K3_CUDA_SOURCE = "src/repro_torch/csrc/flash_attention.cu"

#: K2 against its plain version: f32 sums by atomics differ from a
#: sequential sum by rounding only (the JAX package's test tolerance)
K2_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-1)}
#: served logits against the plain CPU path on the same block
GNN_TOL = 1e-5
#: K3 against its plain version (rtol and atol): the JAX package's own
#: kernel tolerances; f32 holds only because no product runs in TF32
K3_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
#: f32 LM logits of the K3 path against the plain path on the card
#: (rtol and atol): the same weights and prompts, sums in another order
LM_TOL = 1e-3
#: hot-set budget of each engine in the sharded traversal run (bytes as
#: ``HotSetStats`` charges them, 8 an edge)
TRAVERSAL_HOTSET = 64 << 20
#: traversal requests sent one at a time, by kind, per topology: a path
#: request on the scale-23 file takes 5-13 s (NVIDIA H100 80GB HBM3,
#: 700.00 W; PERF.md), so it gets fewer (4 since the training and compile
#: phases joined the run, to keep the whole script well inside its time
#: limit on a slow host)
TRAVERSAL_SEQUENTIAL = {"khop": 30, "bfs": 30, "path": 4}
#: fewest latencies of a kind whose nearest-rank p99 is reported; below
#: it only p50 and the largest are
P99_MIN_N = 30
#: tokens of the served-dtype run whose every attention call is held to
#: f64 (1 prefill + 3 decode steps: both of K3's bf16 designs)
LM_SHADOW_TOKENS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phases 4-6: the main path, as functions of (device, scale)
# ---------------------------------------------------------------------------

def _cuda_sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _quantiles(lat: list) -> tuple[float, float]:
    """(p50, p99) of a list of latencies, nearest rank."""
    s = sorted(lat)
    return s[len(s) // 2], s[min(len(s) - 1, int(0.99 * len(s)))]


def _mean_tiers(roots: list) -> dict:
    """Exclusive seconds per tier, averaged over the traced roots."""
    tiers: dict = {}
    for root in roots:
        for tier, sec in tier_times(root).items():
            tiers[tier] = tiers.get(tier, 0.0) + sec / max(1, len(roots))
    return tiers


def make_graph(scale: int, workdir: str, fmt: str = "compbin",
               edge_factor: int = 16, seed: int = 0):
    """Generate ``rmat(scale, edge_factor)`` and write it as ``fmt``.
    Returns (csr, path, seconds to generate, seconds to write)."""
    t0 = time.perf_counter()
    csr = rmat(scale, edge_factor, seed=seed)
    t1 = time.perf_counter()
    suffix = {"compbin": "cbin", "logcsr": "lgsr"}[fmt]
    path = os.path.join(workdir, f"rmat{scale}.{suffix}")
    save_graph(path, csr, format=fmt)
    return csr, path, t1 - t0, time.perf_counter() - t1


def phase_load(csr, path: str, device) -> dict:
    """Stream the file to ``device`` through PG-Fuse (sequential plan) and
    hold the assembled CSR against ``csr`` bit for bit."""
    on_gpu = torch.device(device).type == "cuda"
    amode = policy.choose_access_mode("stream")
    launches0 = compbin_decode.launches
    with open_graph(path, use_pgfuse=True, pgfuse_readahead=amode.readahead,
                    pgfuse_eviction=amode.eviction) as g:
        b = g.bytes_per_id
        with stream_partitions(g, device) as stream:
            shards = list(stream)           # every shard stays resident
        st = stream.stats
    launched = compbin_decode.launches - launches0
    assert st.decode_mode == "device", st.decode_reason
    assert st.host_decode_bytes == 0, st.host_decode_bytes
    assert st.partitions == len(shards) > 0
    for s in shards:
        assert s.neighbors.dtype == torch.int32
        assert s.offsets.dtype == torch.int64
        assert s.neighbors.is_cuda == on_gpu and s.offsets.is_cuda == on_gpu
        assert s.neighbors.shape == (s.n_edges,)
    # one launch per partition: even an empty one ships its 1024-id bucket
    assert launched == (len(shards) if on_gpu else 0), (launched, len(shards))
    out = assemble_csr(shards)
    assert out.offsets.dtype == np.int64
    assert np.array_equal(out.offsets, csr.offsets), "offsets differ"
    assert np.array_equal(out.neighbors, csr.neighbors), "neighbors differ"
    d = st.as_dict()
    return {"b": b, "partitions": st.partitions, "vertices": st.vertices,
            "edges": st.edges, "bytes_h2d": st.bytes_h2d,
            "wall_s": d["wall_s"], "edges_per_s": d["edges_per_s"],
            "h2d_bytes_per_s": d["h2d_bytes_per_s"],
            "decode_s": d["decode_s"], "launches": launched,
            "cache_hits": st.cache_hits, "cache_misses": st.cache_misses,
            "underlying_bytes": st.underlying_bytes,
            "max_partition_ids": max(stream_bucket_ids(s.n_edges)
                                     for s in shards)}


def _check_answers(csr, vertices, answers) -> int:
    """Every answer is int64 and equals the CSR's slice; returns the
    number of neighbor ids checked."""
    assert len(answers) == len(vertices)
    lo, hi = csr.offsets[vertices], csr.offsets[vertices + 1]
    assert [len(a) for a in answers] == (hi - lo).tolist(), "degree differs"
    for a in answers:
        assert a.dtype == np.int64
    want = np.concatenate([csr.neighbors[s:e] for s, e in zip(lo, hi)]
                          + [np.zeros(0, csr.neighbors.dtype)])
    got = np.concatenate(list(answers) + [np.zeros(0, np.int64)])
    assert np.array_equal(got, want.astype(np.int64)), "neighbor ids differ"
    return int(got.size)


def phase_serve(csr, path: str, device, *, n_batches: int = 32,
                batch: int = 1024, n_async: int = 4, n_auto: int = 4,
                n_traced: int = 4, seed: int = 1) -> dict:
    """Answer seeded random neighbor queries from the file through
    PG-Fuse (random-access plan) with the device decode, the async
    ``submit`` path, one ``decode="auto"`` run and a few span-traced
    batches (where a batch's time goes, by tier); every answer is held
    against ``csr``."""
    on_gpu = torch.device(device).type == "cuda"
    amode = policy.choose_access_mode("serve")
    rng = np.random.default_rng(seed)
    budget = max(64 * SERVE_BLOCK_SIZE, os.path.getsize(path) // 2)
    launches0 = compbin_decode.launches

    def mount():
        return open_graph(path, use_pgfuse=True,
                          pgfuse_block_size=SERVE_BLOCK_SIZE,
                          pgfuse_readahead=amode.readahead,
                          pgfuse_eviction=amode.eviction,
                          pgfuse_max_resident_bytes=budget)

    lat, checked = [], 0
    with mount() as g, NeighborQueryEngine(g, decode="device",
                                           device=device) as eng:
        for _ in range(n_batches):
            vs = rng.integers(0, g.n_vertices, batch)
            t0 = time.perf_counter()
            ans = eng.neighbors_batch(vs)
            lat.append(time.perf_counter() - t0)
            checked += _check_answers(csr, vs, ans)
        sync_batches = eng.stats.batches
        assert eng.stats.device_batches == sync_batches == n_batches
        # the async path: concurrent requests coalesce into micro-batches
        reqs = [rng.integers(0, g.n_vertices, batch // 4)
                for _ in range(n_async)]
        futs = [eng.submit(vs) for vs in reqs]
        for vs, fut in zip(reqs, futs):
            checked += _check_answers(csr, vs, fut.result(timeout=120))
        qs = eng.stats.as_dict()
    assert qs["device_batches"] == qs["batches"] > sync_batches
    assert qs["bytes_h2d"] > 0
    assert sum(qs["close_reasons"].values()) == qs["batches"]
    launched_device = compbin_decode.launches - launches0
    assert launched_device == (qs["batches"] if on_gpu else 0)

    # decode="auto": policy places each batch by its exact edge mass
    want_device = 0
    with mount() as g, NeighborQueryEngine(g, decode="auto",
                                           device=device) as eng:
        for _ in range(n_auto):
            vs = rng.integers(0, g.n_vertices, batch)
            uniq = np.unique(vs)
            mass = int((csr.offsets[uniq + 1] - csr.offsets[uniq]).sum())
            want_device += int(policy.choose_query_decode(
                mass, g.bytes_per_id, n_vertices=g.n_vertices).device)
            checked += _check_answers(csr, vs, eng.neighbors_batch(vs))
        auto = eng.stats.as_dict()
    assert auto["device_batches"] == want_device, (auto, want_device)

    # span-traced batches: exclusive seconds per tier (gather = the
    # batching machinery, storage = PG-Fuse reads, decode = H2D copy +
    # kernel + D2H on the device arm)
    tracer = Tracer()
    with mount() as g, NeighborQueryEngine(g, decode="device", device=device,
                                           tracer=tracer) as eng:
        for _ in range(n_traced):
            vs = rng.integers(0, g.n_vertices, batch)
            checked += _check_answers(csr, vs, eng.neighbors_batch(vs))
    tiers = _mean_tiers(tracer.drain())
    launched = compbin_decode.launches - launches0
    assert launched == (launched_device + want_device + n_traced
                        if on_gpu else 0)
    p50, p99 = _quantiles(lat)
    return {"batches": qs["batches"], "device_batches": qs["device_batches"],
            "requests": qs["requests"], "edges_returned": qs["edges_returned"],
            "bytes_h2d": qs["bytes_h2d"], "close_reasons": qs["close_reasons"],
            "auto_device_batches": auto["device_batches"],
            "auto_batches": auto["batches"], "ids_checked": checked,
            "tier_s_per_traced_batch": tiers,
            "p50_s": p50, "p99_s": p99, "launches": launched}


def phase_logcsr(device, scale: int, workdir: str, *, n_batches: int = 8,
                 batch: int = 256) -> dict:
    """The same load and serve over a LogCSR file: its neighbors share
    CompBin's packed layout, so the same kernel decodes them."""
    csr, path, _, _ = make_graph(scale, workdir, "logcsr", seed=3)
    load = phase_load(csr, path, device)
    serve = phase_serve(csr, path, device, n_batches=n_batches, batch=batch,
                        n_async=2, n_auto=2, seed=4)
    return {"load": load, "serve": serve}


def hotset_trace(degrees: np.ndarray, n_batches: int, batch: int, *,
                 hot_fraction: float = 0.6, seed: int = 0):
    """Degree-correlated zipf traffic, built as ``benchmarks/hotset.py``
    builds it: ``hot_fraction`` of the lookups hit the top-degree hubs
    (``max(16, n >> 10)`` of them), the rest are uniform.  Returns (list
    of int64 batches, hub ids)."""
    n = degrees.shape[0]
    hubs = np.argsort(degrees)[::-1][:max(16, n >> 10)].astype(np.int64)
    rng = np.random.default_rng(seed)
    trace = []
    for _ in range(n_batches):
        hot = hubs[rng.integers(0, len(hubs), batch)]
        cold = rng.integers(0, n, batch)
        trace.append(np.where(rng.random(batch) < hot_fraction, hot, cold))
    return trace, hubs


def phase_hotset(csr, path: str, device, *, n_batches: int = 48,
                 batch: int = 1024, seed: int = 0) -> dict:
    """One seeded hub-heavy trace through a cold engine and through one
    with the device-resident hot-set tier (budget ``max(64 KiB, 1.5 x``
    the hub runs' bytes), as ``benchmarks/hotset.py`` sizes it), both with
    ``decode="auto"`` over the random-access mount of ``phase_serve``.
    Every answer of both arms is held to ``csr`` bit for bit as int64;
    K1's launch delta of each arm must equal its device batches.  Reports
    per-batch p50/p99 (host clock), hit rate, launches, ``HotSetStats``
    and the bytes the tier holds on the card (``memory_allocated`` after
    the trace less before it)."""
    from repro_torch.query import BYTES_PER_EDGE

    on_gpu = torch.device(device).type == "cuda"
    amode = policy.choose_access_mode("serve")
    degrees = np.diff(csr.offsets)
    trace, hubs = hotset_trace(degrees, n_batches, batch, seed=seed)
    hub_bytes = int(degrees[hubs].sum()) * BYTES_PER_EDGE
    budget = max(1 << 16, int(1.5 * hub_bytes))
    pg_budget = max(64 * SERVE_BLOCK_SIZE, os.path.getsize(path) // 2)
    out = {"hubs": int(len(hubs)), "hub_edges": int(degrees[hubs].sum()),
           "budget_bytes": budget, "batches": n_batches, "batch": batch}
    t_phase = time.perf_counter()
    for arm, hot in (("cold", None), ("hot", budget)):
        _cuda_sync(device)
        mem0 = torch.cuda.memory_allocated(device) if on_gpu else 0
        launches0 = compbin_decode.launches
        lat, checked = [], 0
        tracer = Tracer(sample_every=4)
        with open_graph(path, use_pgfuse=True,
                        pgfuse_block_size=SERVE_BLOCK_SIZE,
                        pgfuse_readahead=amode.readahead,
                        pgfuse_eviction=amode.eviction,
                        pgfuse_max_resident_bytes=pg_budget) as g, \
                NeighborQueryEngine(g, decode="auto", hotset=hot,
                                    device=device, tracer=tracer) as eng:
            if hot is not None:
                assert eng.hotset.plan.place == "device", eng.hotset.plan
            for vs in trace:
                t0 = time.perf_counter()
                ans = eng.neighbors_batch(vs)
                lat.append(time.perf_counter() - t0)
                checked += _check_answers(csr, vs, ans)
            _cuda_sync(device)
            mem1 = torch.cuda.memory_allocated(device) if on_gpu else 0
            qs = eng.stats.as_dict()
            pg_hit = g.fs.stats().as_dict()["hit_rate"]
            hs = eng.hotset.stats.as_dict() if hot is not None else None
            if hot is not None:
                # the resident runs sit where the tier was told to put them
                first = eng.hotset._entries[int(
                    eng.hotset.resident_vertices[0])]
                assert isinstance(first.store, torch.Tensor) and \
                    first.store.device.type == torch.device(device).type, \
                    f"resident runs are not on {device}: {type(first.store)}"
                assert not on_gpu or mem1 > mem0, (mem0, mem1)
                # after the books are read: what one hit costs (the
                # device-to-host copy and sync of its run included)
                ids = eng.hotset.resident_vertices[:1024]
                t0 = time.perf_counter()
                eng.hotset.lookup(ids)
                hit_us = (time.perf_counter() - t0) / max(1, ids.size) * 1e6
        launched = compbin_decode.launches - launches0
        assert launched == (qs["device_batches"] if on_gpu else 0), \
            (arm, launched, qs["device_batches"])
        p50, p99 = _quantiles(lat)
        r = out[arm] = {
            "p50_s": p50, "p99_s": p99, "latency_s": lat,
            "launches": launched, "device_batches": qs["device_batches"],
            "batches": qs["batches"], "bytes_h2d": qs["bytes_h2d"],
            "edges_returned": qs["edges_returned"], "ids_checked": checked,
            "card_bytes": mem1 - mem0, "pgfuse_hit_rate": pg_hit,
            "blocks_touched": qs["blocks_touched"],
            "tier_s_per_traced_batch": _mean_tiers(tracer.drain())}
        if hs is not None:
            assert hs["lookups"] == hs["hits"] + hs["misses"], hs
            assert hs["fills"] == (hs["admitted"] + hs["bypassed"]
                                   + hs["rejected"]), hs
            assert hs["resident_bytes"] <= budget, hs
            assert hs["hits"] > 0, hs
            r["hotset"] = hs
            r["lookup_us_per_hit"] = hit_us
    out["launches"] = out["cold"]["launches"] + out["hot"]["launches"]
    out["hot_over_cold_p50"] = out["hot"]["p50_s"] / out["cold"]["p50_s"]
    out["wall_s"] = time.perf_counter() - t_phase
    return out



def plain_traverse(csr, kind: str, seeds, *, k=None, target=None,
                   max_edges: int, max_vertices=None) -> dict:
    """An independent plain-numpy traversal on the in-memory CSR with the
    query service's documented semantics (``repro_torch.query.traversal``
    module docstring): seeds deduplicated and sorted at depth 0; before
    each hop stop on found / empty frontier / ``hop == k`` / edges
    scanned over ``max_edges`` / visit bound; new vertices join in
    ascending id, trimmed to the visit bound; a path's parent is the
    smallest-id frontier vertex adjacent to the discovery.  A boolean
    visit mask and per-hop vectorised gathers, nothing of the service."""
    off, nbr = csr.offsets, csr.neighbors
    n = csr.n_vertices
    seeds = np.unique(np.asarray(seeds, dtype=np.int64))
    mv = n if max_vertices is None else max_vertices
    truncated = bool(seeds.size > mv)
    seeds = seeds[:mv]
    seen = np.zeros(n, dtype=bool)
    seen[seeds] = True
    n_seen = int(seeds.size)
    order, depths, parent = [seeds], [np.zeros(seeds.size, np.int64)], {}
    frontier = seeds
    found = target is not None and bool(seen[target])
    edges = hops = 0
    while not (found or frontier.size == 0 or (k is not None and hops == k)):
        if edges > max_edges or n_seen >= mv:
            truncated = True
            break
        lo, deg = off[frontier], off[frontier + 1] - off[frontier]
        total = int(deg.sum())
        idx = (np.arange(total, dtype=np.int64)
               - np.repeat(np.cumsum(deg) - deg, deg) + np.repeat(lo, deg))
        dst = nbr[idx].astype(np.int64)
        hops += 1
        edges += total
        new = np.unique(dst[~seen[dst]])
        if new.size > mv - n_seen:
            new, truncated = new[:mv - n_seen], True
        if target is not None and new.size:
            mark = np.zeros(n, dtype=bool)
            mark[new] = True
            hit = mark[dst]
            d, s = dst[hit], np.repeat(frontier, deg)[hit]
            o = np.lexsort((s, d))
            d, s = d[o], s[o]
            first = np.ones(d.size, dtype=bool)
            first[1:] = d[1:] != d[:-1]
            parent.update(zip(d[first].tolist(), s[first].tolist()))
            found = bool(mark[target])
        seen[new] = True
        n_seen += int(new.size)
        order.append(new)
        depths.append(np.full(new.size, hops, np.int64))
        frontier = new
    path = None
    if kind == "path" and found:
        chain = [int(target)]
        while chain[-1] in parent:
            chain.append(parent[chain[-1]])
        path = chain[::-1]
    return {"vertices": np.concatenate(order), "depths": np.concatenate(depths),
            "found": found, "path": path, "truncated": truncated,
            "hops": hops, "edges_scanned": edges}


def check_traversal(csr, req, res) -> int:
    """``res`` equals :func:`plain_traverse` of ``req``: visit set and
    order, depths, path and its length, hops, edges scanned, truncation.
    Returns the number of vertices checked."""
    want = plain_traverse(csr, req.kind, req.seeds, k=req.k,
                          target=req.target, max_edges=req.max_edges,
                          max_vertices=req.max_vertices)
    assert res.vertices.dtype == np.int64, res.vertices.dtype
    assert np.array_equal(res.vertices, want["vertices"]), \
        f"{req.kind}: visit set differs"
    assert np.array_equal(res.depths, want["depths"]), \
        f"{req.kind}: depths differ"
    assert res.found == want["found"], f"{req.kind}: found differs"
    if want["path"] is None:
        assert res.path is None, f"{req.kind}: path differs"
    else:
        assert res.path is not None and len(res.path) == len(want["path"]), \
            f"{req.kind}: path length differs"
        assert res.path.tolist() == want["path"], f"{req.kind}: path differs"
    assert (res.hops, res.edges_scanned, res.truncated) == (
        want["hops"], want["edges_scanned"], want["truncated"]), \
        f"{req.kind}: budgets differ"
    return int(res.vertices.size)


def phase_traversal(csr, path: str, device, *, shards: int = 1,
                    replication: int = 1, hotset_bytes=None,
                    sequential: dict = None, batch: int = 16,
                    n_concurrent: int = 9, seed: int = 0) -> dict:
    """``serve_traversal``'s mix (k-hop k=2, BFS visit bounded at
    ``4 * batch`` vertices, shortest path; half the seeds hub-biased)
    through ``make_traversal_server(path=..., device=...)``: first one
    request at a time, ``sequential[kind]`` of each kind (default
    :data:`TRAVERSAL_SEQUENTIAL`) in the mix's order, for per-kind
    host-clock latency (p99 only from :data:`P99_MIN_N` on), then
    ``n_concurrent``
    more submitted at once to the service's executor threads, each calling
    the engine(s) and so launching K1 from several threads (a shed
    request is counted, not answered).  Every completed answer is held to
    :func:`plain_traverse`; each kind must complete at least once; K1's
    launch delta must equal the device batches of every engine, merged
    across shard replicas."""
    from repro_torch.launch.serve import make_traversal_server, traversal_mix
    from repro_torch.query import TraversalShed, merge_query_stats

    on_gpu = torch.device(device).type == "cuda"
    quota = dict(sequential or TRAVERSAL_SEQUENTIAL)
    n_requests = sum(quota.values())
    t_phase = time.perf_counter()
    launches0 = compbin_decode.launches
    tracer = Tracer(max_traces=4 * (n_requests + n_concurrent))
    service, close = make_traversal_server(
        path=path, device=device, shards=shards, replication=replication,
        hotset_bytes=hotset_bytes, tracer=tracer)
    lat = {"khop": [], "bfs": [], "path": []}
    checked = shed = shed_concurrent = 0
    found = 0
    try:
        n, budget = service.n_vertices, service.default_max_edges
        for req in traversal_mix(n, 3 * max(quota.values()), batch,
                                 max_edges=budget, seed=seed):
            if quota[req.kind] == 0:
                continue
            quota[req.kind] -= 1
            t0 = time.perf_counter()
            try:
                res = service.request(req)
            except TraversalShed:
                shed += 1
                continue
            lat[req.kind].append(time.perf_counter() - t0)
            checked += check_traversal(csr, req, res)
            found += bool(res.found)
        futures = []
        t0 = time.perf_counter()
        for req in traversal_mix(n, n_concurrent, batch, max_edges=budget,
                                 seed=seed + 1):
            try:
                futures.append((req, service.submit(req)))
            except TraversalShed:
                shed_concurrent += 1
        for req, fut in futures:
            checked += check_traversal(csr, req, fut.result(timeout=600))
        concurrent_s = time.perf_counter() - t0
        backend = service.engine
        engines = ([rep.engine for row in backend.replicas for rep in row]
                   if hasattr(backend, "replicas") else [backend])
        qs = merge_query_stats(e.stats for e in engines)
        d = service.as_dict()
        threads = len(service._executor._threads) if service._executor \
            else 0
    finally:
        close()
    roots = tracer.drain()
    launched = compbin_decode.launches - launches0
    assert launched == (qs.device_batches if on_gpu else 0), \
        (launched, qs.device_batches)
    assert all(lat.values()), {k: len(v) for k, v in lat.items()}
    ts = d["traversal"]
    assert ts["submitted"] == ts["admitted"] + ts["shed"], ts
    assert ts["completed"] == n_requests + n_concurrent - shed \
        - shed_concurrent, ts
    out = {"shards": shards, "replication": replication,
           "hotset_bytes": hotset_bytes, "batch": batch,
           "requests": n_requests + n_concurrent,
           "completed": ts["completed"], "shed": ts["shed"],
           "shed_rate": ts["shed_rate"], "p50_s": ts["p50_s"],
           "p99_s": ts["p99_s"], "frontier_batches": ts["frontier_batches"],
           "edges_scanned": ts["edges_scanned"],
           "vertices_checked": checked, "paths_found": found,
           "device_batches": qs.device_batches, "engine_batches": qs.batches,
           "launches": launched, "executor_threads": threads,
           "concurrent_s": concurrent_s, "per_kind": {},
           "wall_s": time.perf_counter() - t_phase}
    for kind, xs in lat.items():
        p50, p99 = _quantiles(xs)
        out["per_kind"][kind] = {
            "n": len(xs), "p50_s": p50,
            "p99_s": p99 if len(xs) >= P99_MIN_N else None,
            "max_s": max(xs),
            "tier_s_per_request": _mean_tiers(
                [r for r in roots if r.attrs.get("kind") == kind])}
    if "hotset" in d:
        out["hotset"] = d["hotset"]
    if hasattr(backend, "router"):
        out["router"] = backend.router.as_dict()
    return out


def _zipf_requests(n_vertices: int, n_requests: int, batch: int,
                   rng) -> list:
    """Request seed batches drawn as ``serve_gnn`` draws them: half the
    traffic on the top ~1/16 of vertices."""
    out = []
    for _ in range(n_requests):
        hot = rng.integers(0, max(1, n_vertices // 16), batch)
        cold = rng.integers(0, n_vertices, batch)
        out.append(np.where(rng.random(batch) < 0.5, hot, cold))
    return out


def gnn_plain_logits(gp: str, fp: str, cfg, params: dict, fanouts,
                     seed: int, requests: list, arch: str = "gcn-cora"):
    """The plain CPU path the served logits are held against: an
    in-memory CSR sampler with the server's seed, feature rows read
    straight out of the store file (``np.memmap``, no PG-Fuse, no
    gather), and ``arch``'s forward on CPU tensors.  Yields (logits,
    block edge_dst, block node count) per request."""
    from repro_torch.core import featstore
    from repro_torch.graph import NeighborSampler
    from repro_torch.launch.data_gnn import block_to_edges
    from repro_torch.launch.steps import _GNN_MODULES

    with open_graph(gp) as g:
        csr = g.read_full()
    with featstore.FeatStoreFile(fp) as f:
        h = f.header
    assert h.row_stride == h.row_bytes, "padded rows"
    x_all = np.memmap(fp, dtype=h.dtype, mode="r", offset=h.data_start,
                      shape=(h.n_rows, h.d))
    sampler = NeighborSampler(csr, fanouts, seed=seed)
    for seeds in requests:
        block = sampler.sample(seeds)
        src, dst, n = block_to_edges(block)
        nodes = np.concatenate(block.layer_nodes)
        valid = np.concatenate(block.layer_valid)
        x = np.zeros((n, h.d), np.float32)
        x[valid] = x_all[nodes[valid]]
        batch = {"x": torch.from_numpy(x),
                 "edge_src": torch.from_numpy(src.astype(np.int32)),
                 "edge_dst": torch.from_numpy(dst.astype(np.int32))}
        with torch.inference_mode():
            logits = _GNN_MODULES[arch].forward(params, batch, cfg)
        yield logits[:len(seeds)].numpy(), dst.astype(np.int32), n


def phase_gnn(device, workdir: str, *, scale: int = 18,
              edge_factor: int = 16, reduced: bool = False,
              n_requests: int = 8, batch: int = 1024,
              fanouts=(5, 5), seed: int = 0, arch: str = "gcn-cora") -> dict:
    """GNN inference serving from CompBin through the port's
    ``make_gnn_server`` (``arch``: gcn-cora or pna, full width unless
    ``reduced``): ``n_requests`` zipf-drawn batches of ``batch`` seeds,
    every request span-traced, every request's logits held against the
    plain CPU path on the same block (:func:`gnn_plain_logits`) at
    ``GNN_TOL``; K2 launches as the requests ask (:func:`k2_as_asked`)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.data_gnn import ensure_gnn_assets
    from repro_torch.launch.serve import make_gnn_server
    from repro_torch.launch.steps import _GNN_MODULES

    on_gpu = torch.device(device).type == "cuda"
    spec = get_arch(arch)
    cfg = spec.make_reduced() if reduced else spec.make_config()
    t0 = time.perf_counter()
    gp, fp, _ = ensure_gnn_assets(workdir, cfg.d_in, cfg.n_classes,
                                  scale=scale, edge_factor=edge_factor)
    assets_s = time.perf_counter() - t0
    params = _GNN_MODULES[arch].init_params(
        cfg, torch.Generator().manual_seed(seed))
    k1_0 = compbin_decode.launches
    tracer = Tracer()
    with k2_as_asked(f"[gnn] {arch} served") as asked:
        answer, engine, close = make_gnn_server(
            arch, cfg, workdir, fanouts=fanouts, seed=seed, decode="auto",
            device=device, params=params, scale=scale,
            edge_factor=edge_factor, tracer=tracer)
        try:
            requests = _zipf_requests(engine.n_vertices, n_requests, batch,
                                      np.random.default_rng(seed + 1))
            lat, served = [], []
            for seeds in requests:
                t1 = time.perf_counter()
                served.append(answer(seeds))
                lat.append(time.perf_counter() - t1)
            qs = engine.stats.as_dict()
            n_vertices = engine.n_vertices
            file_bytes = {"graph": os.path.getsize(gp),
                          "features": os.path.getsize(fp)}
        finally:
            close()
    k1, k2 = compbin_decode.launches - k1_0, asked.launches()["k2"]
    traces = tracer.drain()
    assert len(traces) == n_requests, len(traces)
    tiers = _mean_tiers(traces)
    worst = 0.0
    for got, (want, dst, n_nodes) in zip(
            served, gnn_plain_logits(gp, fp, cfg, params, fanouts, seed,
                                     requests, arch)):
        assert got.shape == want.shape == (batch, cfg.n_classes), got.shape
        assert np.isfinite(got).all(), "non-finite logits"
        worst = max(worst, float(np.abs(got - want).max()))
        assert np.allclose(got, want, rtol=GNN_TOL, atol=GNN_TOL), \
            f"served logits differ from the plain path (max {worst})"
    if on_gpu:
        assert k1 > 0 and qs["device_batches"] > 0, (k1, qs)
    else:
        assert k1 == 0
    p50, p99 = _quantiles(lat[1:] or lat)
    return {"arch": cfg.name, "d_in": cfg.d_in, "d_hidden": cfg.d_hidden,
            "n_classes": cfg.n_classes, "scale": scale,
            "edge_factor": edge_factor, "vertices": n_vertices,
            "file_bytes": file_bytes, "assets_s": assets_s,
            "requests": n_requests, "batch": batch,
            "fanouts": list(fanouts), "nodes_per_request": n_nodes,
            "edge_slots_per_request": int(dst.size),
            "valid_edges_last_request": int((dst >= 0).sum()),
            "feature_bytes_per_request": n_nodes * cfg.d_in * 4,
            "latency_s": lat, "p50_s": p50, "p99_s": p99,
            "first_request_s": lat[0],
            "tier_s_per_request": tiers, "max_abs_err": worst,
            "k1_launches": k1, "k2_launches": k2,
            "query_batches": qs["batches"],
            "device_batches": qs["device_batches"],
            "bytes_h2d_decode": qs["bytes_h2d"],
            "edge_dst": dst, "n_nodes": n_nodes}


@contextlib.contextmanager
def plain_attention():
    """Every attention call of the port's transformer on its plain paths
    (the JAX package's dense / chunked backends), on any device: the
    yardstick the K3 path is held against."""
    from repro_torch.models import transformer as tf

    saved = tf.attention
    tf.attention = tf.attention_plain
    try:
        yield
    finally:
        tf.attention = saved


def attention_f64(q, k, v, q_offset: int) -> torch.Tensor:
    """Causal GQA attention of [B, S, H, dh] q over the first
    ``q_offset + S`` positions of [B, T, Hk, dh] k/v, computed densely in
    float64: the truth both f32 paths are held to."""
    b, sq, hq, dh = q.shape
    live = q_offset + sq
    g = hq // k.shape[2]
    kd = k[:, :live].double().repeat_interleave(g, 2)
    vd = v[:, :live].double().repeat_interleave(g, 2)
    s = torch.einsum("bshd,bthd->bhst", q.double(), kd) * dh ** -0.5
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(live, device=q.device)[None, :]
    s = s.masked_fill(kpos > qpos, float("-inf"))
    return torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), vd)


@contextlib.contextmanager
def shadow_attention(errs: list):
    """Every attention call of the port's transformer is also computed in
    float64 on the same q/k/v (the live cache as it is at that step) and
    by the plain path in the served dtype.  The served output is held to
    the f64 one at rtol ``K3_TOL`` and atol ``K3_TOL`` x max(1, max|v|):
    the output is a convex combination of V rows, and the served model's
    V runs to ~60 where the JAX package's sweep draws it from N(0, 1), so
    the absolute floor scales with V while the relative part does not.
    Appends ``(served error, plain-path error, atol)`` against f64 per
    call; the plain path launches no kernel."""
    from repro_torch.models import transformer as tf

    served = tf.attention

    def attention(q, k, v, cfg, *, causal, q_offset=0):
        out = served(q, k, v, cfg, causal=causal, q_offset=q_offset)
        truth = attention_f64(q, k, v, q_offset)
        plain = tf.attention_plain(q, k, v, cfg, causal=causal,
                                   q_offset=q_offset)
        err = float((out.double() - truth).abs().max())
        rtol = K3_TOL[out.dtype]
        atol = rtol * max(1.0, float(
            v[:, :q_offset + q.shape[1]].abs().max()))
        assert out.shape == truth.shape and torch.allclose(
            out.double(), truth, rtol=rtol, atol=atol), \
            f"served attention != f64 attention (max abs err {err}, " \
            f"rtol {rtol}, atol {atol})"
        errs.append((err, float((plain.double() - truth).abs().max()), atol))
        return out

    tf.attention = attention
    try:
        yield
    finally:
        tf.attention = served


def shadow_summary(errs: list) -> dict:
    """What :func:`shadow_attention` recorded, summed up: the served and
    plain errors' maxima, the range of the per-call atol, the largest
    error as a share of its call's atol, and every call's
    ``(err, plain_err, atol)``."""
    return {"calls": len(errs),
            "max_abs_err": max(e for e, _, _ in errs),
            "plain_max_abs_err": max(p for _, p, _ in errs),
            "atol_min": min(a for _, _, a in errs),
            "atol_max": max(a for _, _, a in errs),
            "worst_err_over_atol": max(e / a for e, _, a in errs),
            "per_call": errs}


def _compare_logits(got_tok, got_l, want_tok, want_l, tol=None) -> dict:
    """Step-by-step comparison of two greedy runs' last-position logits
    ([steps, batch, vocab]).  A row is compared up to its first token
    that differs (after it, the two runs decode other tokens).  With
    ``tol``, every compared step must agree within it (rtol and atol) and
    a token may differ only where ``want``'s top two logits lie within
    ``tol``."""
    n_tokens, batch, _ = got_l.shape
    worst, flips, compared = 0.0, [], 0
    for b in range(batch):
        for t in range(n_tokens):
            err = float(np.abs(got_l[t, b] - want_l[t, b]).max())
            worst = max(worst, err)
            compared += 1
            if tol is not None:
                assert np.allclose(got_l[t, b], want_l[t, b], rtol=tol,
                                   atol=tol), \
                    f"K3-path logits differ from the plain path (max {worst})"
            if got_tok[b, t] != want_tok[b, t]:
                top2 = np.sort(want_l[t, b])[-2:]
                margin = float(top2[1] - top2[0])
                if tol is not None:
                    assert margin <= tol, \
                        f"greedy token differs at row {b} step {t} " \
                        f"(margin {margin})"
                flips.append({"row": b, "step": t, "margin": margin})
                break
    return {"max_abs_err": worst, "flips": flips, "steps_compared": compared,
            "tokens_equal": float((got_tok == want_tok).mean())}


def phase_lm_check(device, cfg, batch: int, prompt_len: int,
                   n_tokens: int, seed: int = 0, e2e_layers: int = 2) -> dict:
    """LM serving through ``serve_lm`` on random weights, the K3 path
    held against the plain attention path on the same card.

    (1) Full depth, every attention call shadowed
    (:func:`shadow_attention`): the served output is held to an f64
    computation on the same inputs, beside the plain path's error.  (2) End to end at
    ``e2e_layers`` layers (the first layers of the same weights): every
    step's last-position logits within ``LM_TOL`` of the plain path,
    greedy tokens equal (a flip allowed only where the plain path's top
    two logits lie within ``LM_TOL``).  (3) End to end at full depth,
    reported, not asserted: with random weights the model amplifies any
    change of f32 rounding by orders of magnitude per layer, so the
    logit difference of the K3 path against the plain path is printed
    beside that of the plain path's two backends (``dense`` against
    ``chunked``) on the same weights and prompts.  On the CPU the K3
    path is the plain path."""
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer as tf

    params = tf.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(seed))
    kw = dict(batch=batch, prompt_len=prompt_len, n_tokens=n_tokens,
              device=device, keep_logits=True)
    errs: list = []
    before = flash_attention.launches
    with shadow_attention(errs):
        k3_tok, k3 = serve_lm(cfg, params=params, **kw)
    launched = flash_attention.launches - before
    assert len(errs) == cfg.n_layers * n_tokens, len(errs)
    with plain_attention():
        plain_tok, plain = serve_lm(cfg, params=params, **kw)
        dense_tok, dense = serve_lm(
            dataclasses.replace(cfg, attn_impl="dense"), params=params, **kw)
    for logits in (k3["logits"], plain["logits"], dense["logits"]):
        assert logits.shape == (n_tokens, batch, cfg.vocab)
        assert np.isfinite(logits).all(), "non-finite logits"
    full = _compare_logits(k3_tok, k3["logits"], plain_tok, plain["logits"])
    yard = _compare_logits(dense_tok, dense["logits"], plain_tok,
                           plain["logits"])

    shallow = dataclasses.replace(cfg, n_layers=e2e_layers)
    sparams = dict(params, layers={k: t[:e2e_layers]
                                   for k, t in params["layers"].items()})
    got_tok, got = serve_lm(shallow, params=sparams, **kw)
    with plain_attention():
        want_tok, want = serve_lm(shallow, params=sparams, **kw)
    e2e = _compare_logits(got_tok, got["logits"], want_tok, want["logits"],
                          tol=LM_TOL)
    for f in e2e["flips"]:
        log(f"[lm] token flip at row {f['row']} step {f['step']} "
            f"({e2e_layers} layers): plain path's top-2 margin "
            f"{f['margin']:.3g} <= {LM_TOL}")
    return {"arch": cfg.name, "dtype": str(cfg.dtype), "batch": batch,
            "prompt_len": prompt_len, "n_tokens": n_tokens,
            "n_layers": cfg.n_layers,
            **{f"shadow_{k}": x for k, x in shadow_summary(errs).items()},
            "e2e_layers": e2e_layers,
            "max_abs_err": e2e["max_abs_err"], "flips": e2e["flips"],
            "steps_compared": e2e["steps_compared"],
            "full_depth_k3_vs_plain": full,
            "full_depth_dense_vs_chunked": yard, "launches": launched}


def k3_instantiations(ptxas_log: str, nvcc: str) -> list:
    """Registers, dynamic shared memory and spills of each K3 kernel
    instantiation, from ``nvcc -Xptxas -v`` (names demangled by the
    toolkit's ``cu++filt`` where there is one; shared memory from the
    library's own table, since ptxas sees no dynamic shared memory)."""
    from repro_torch.kernels.flash_attention.kernel import smem_bytes
    from repro_torch.kernels.flash_attention.ops import DESIGNS

    rows, name, spill = [], None, (0, 0)
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            parts = line.replace(",", "").split()
            spill = (int(parts[parts.index("spill") - 2]),
                     int(parts[parts.index("loads") - 3]))
        elif "Used" in line and "registers" in line and name:
            rows.append({"mangled": name, "spill_stores": spill[0],
                         "spill_loads": spill[1],
                         "registers": int(line.split("Used")[1].split()[0])})
            name = None
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    for row in rows:
        row["kernel"] = row["mangled"]
        if os.path.exists(filt):
            name = subprocess.run([filt, row["mangled"]], capture_output=True,
                                  text=True).stdout.strip()
            name = name[:name.rfind(">(") + 1] if ">(" in name else name
            for junk in ("void ", "<unnamed>::", "(anonymous namespace)::",
                         "(int)", "(bool)"):
                name = name.replace(junk, "")
            row["kernel"] = name
        dh = 128 if "128" in row["kernel"] or "Li128" in row["mangled"] else 64
        m = row["mangled"]
        if "k3_tc" in m:
            design, bf16 = ("tc_prefill" if "Lb0" in m else "split_decode"), True
        elif "k3_fma" in m:
            design, bf16 = ("split_decode" if "Lb1" in m else "fma"), False
        else:                       # the combine: no dynamic shared memory
            row["smem_bytes"] = 0
            continue
        row["smem_bytes"] = smem_bytes(DESIGNS[design], dh, bf16)
    return rows


def phase_lm_shadow(device, cfg, params, batch: int, prompt_len: int,
                    n_tokens: int) -> dict:
    """LM serving in ``cfg``'s own dtype at full depth with every
    attention call shadowed (:func:`shadow_attention`): each call within
    rtol ``K3_TOL[dtype]``, atol ``K3_TOL[dtype]`` x max(1, max|v|) of
    f64 attention on the same inputs.  On the card, in bf16, the prefill
    runs the tensor-core design and each decode step the split design,
    so this holds both on the served model's real activations."""
    from repro_torch.launch.serve import serve_lm

    errs: list = []
    before = flash_attention.launches
    with shadow_attention(errs):
        tokens, t = serve_lm(cfg, batch=batch, prompt_len=prompt_len,
                             n_tokens=n_tokens, device=device, params=params,
                             keep_logits=True)
    launched = flash_attention.launches - before
    assert len(errs) == cfg.n_layers * n_tokens, len(errs)
    assert tokens.shape == (batch, n_tokens)
    assert np.isfinite(t["logits"]).all(), "non-finite logits"
    return {"dtype": str(cfg.dtype), "batch": batch,
            "prompt_len": prompt_len, "n_tokens": n_tokens,
            "n_layers": cfg.n_layers, **shadow_summary(errs),
            "launches": launched}


def _kernel_class(name: str) -> str:
    if "k3_" in name or "flash_attention" in name:
        return "k3"
    low = name.lower()
    if any(w in low for w in ("gemm", "xmma", "cutlass", "cublas", "nvjet",
                              "gemv", "splitk")):
        return "gemm"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def profile_device(work, classify, classes) -> tuple[float, dict, list]:
    """``work()`` once under ``torch.profiler``: (host-clock wall seconds
    to a synchronise, device milliseconds summed by ``classify(kernel
    name)`` over ``classes``, [(ms, launches, name)] by kernel).  Only
    device events count (a host op's own entry repeats its kernels'
    time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sums = dict.fromkeys(classes, 0.0)
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us:
            sums[classify(ev.key)] += us / 1e3
            kernels.append((us / 1e3, ev.count, ev.key[:60]))
    return wall, sums, kernels


def lm_device_split(cfg, params, batch: int, prompt_len: int,
                    n_decode: int, classify=None,
                    classes=("k3", "gemm", "copy", "other")) -> dict:
    """Where one prefill and ``n_decode`` decode steps spend the card's
    time: ``torch.profiler`` device time summed by kernel class (K3,
    GEMM, copies, other: norms, RoPE, SwiGLU, casts, argmax; ``classify``
    and ``classes`` name others, the MoE's K2 among them) against the
    host-clock wall of the same profiled work (:func:`profile_device`);
    with no device time at all the split is reported as not measured
    (None)."""
    from repro_torch.models import transformer as tf

    rng = np.random.default_rng(1)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab,
                                           (batch, prompt_len)),
                              device="cuda")
    out = {}
    with torch.inference_mode():
        for part in ("prefill", "decode"):
            if part == "prefill":
                def work():
                    return tf.prefill(params, prompts, cfg,
                                      max_len=prompt_len + n_decode + 1)
            else:
                _, cache = tf.prefill(params, prompts, cfg,
                                      max_len=prompt_len + n_decode + 1)
                toks = prompts[:, -1:]

                def work():
                    for _ in range(n_decode):
                        tf.decode_step(params, toks, cache, cfg)
            wall, sums, kernels = profile_device(
                work, classify or _kernel_class, classes)
            busy = sum(sums.values())
            steps = 1 if part == "prefill" else n_decode
            out[part] = {"wall_ms": wall * 1e3 / steps,
                         "device_ms": ({k: v / steps for k, v in sums.items()}
                                       if busy else None),
                         "idle_share": (1 - busy / (wall * 1e3))
                         if busy else None,
                         "top_kernels": [(ms / steps, n // steps, name)
                                         for ms, n, name in
                                         sorted(kernels, reverse=True)[:8]]}
    return out


def phase_lm_serve(device, cfg, batch: int, prompt_len: int,
                   n_tokens: int, seed: int = 0, params=None) -> dict:
    """LM serving at ``cfg``'s own dtype through ``serve_lm``, timed; its
    greedy tokens and logits are checked for shape, range and
    finiteness.  Returns its timings and K3 launches.  ``params``
    defaults to random weights seeded ``seed`` on ``device``."""
    from repro_torch.configs.shapes import LMShape
    from repro_torch.launch.model_flops import lm_model_flops
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer as tf

    if params is None:
        params = tf.init_params(cfg, torch.Generator(device=device)
                                .manual_seed(seed))
    before = flash_attention.launches
    tokens, t = serve_lm(cfg, batch=batch, prompt_len=prompt_len,
                         n_tokens=n_tokens, device=device, params=params,
                         keep_logits=True)
    launched = flash_attention.launches - before
    logits = t.pop("logits")
    assert tokens.shape == (batch, n_tokens), tokens.shape
    assert tokens.min() >= 0 and tokens.max() < cfg.vocab
    assert logits.shape == (n_tokens, batch, cfg.vocab)
    assert np.isfinite(logits).all(), "non-finite logits"
    assert np.array_equal(tokens, logits.argmax(-1).T)
    flops = lm_model_flops(cfg, LMShape("served", prompt_len, batch,
                                        "prefill"))
    steps = max(1, n_tokens - 1)
    return {"arch": cfg.name, "dtype": str(cfg.dtype), "batch": batch,
            "prompt_len": prompt_len, "n_tokens": n_tokens,
            "n_layers": cfg.n_layers, "prefill_ms": t["prefill_s"] * 1e3,
            "decode_ms_per_step": t["decode_s"] / steps * 1e3,
            "tokens_per_s": t["tokens_per_s"], "prefill_flops": flops,
            "prefill_flops_per_s": flops / t["prefill_s"],
            "prefill_bf16_peak_share":
                flops / t["prefill_s"] / BF16_OPS_PER_S,
            "launches": launched}


# ---------------------------------------------------------------------------
# timing on the card
# ---------------------------------------------------------------------------

def time_cuda(fn, *, reps: int = 10, warmup: int = 2, flush=None) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` launches, by CUDA
    events; ``flush`` (a large scratch tensor) is rewritten between
    launches so each one finds the L2 cache cold."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.add_(1)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def bound_ms(n: int, b: int) -> tuple[float, str]:
    """Least time the card could take for ``n`` ids of ``b`` bytes: the
    larger of bytes moved (n*b read, n*4 written) over HBM bandwidth and
    the shift+mask per id over the integer ALU rate."""
    t_bytes = n * (b + 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_packed(n: int, b: int, gen: torch.Generator) -> torch.Tensor:
    return torch.randint(0, 256, (n * b,), dtype=torch.uint8, device="cuda",
                         generator=gen)


def library_call(b: int):
    """The one PyTorch call that computes the same function, where there
    is one (a yardstick only; the port never calls it)."""
    if b == 4:
        return lambda p: p.view(torch.int32).clone()
    if b == 1:
        return lambda p: p.to(torch.int32)
    return None


def measure_kernel(packed: torch.Tensor, b: int, flush) -> dict:
    """Compare kernel and plain version on ``packed`` (bit for bit) and
    time kernel, plain version and library call."""
    n = packed.numel() // b
    got = compbin_decode(packed, b)
    want = compbin_decode_ref(packed, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (n,)
    equal = torch.equal(got, want)
    err = 0 if equal else int((got.long() - want.long()).abs().max())
    assert equal, f"kernel != plain at b={b} n={n} (max abs err {err})"
    del got, want
    ms = time_cuda(lambda: compbin_decode(packed, b), flush=flush)
    plain = time_cuda(lambda: compbin_decode_ref(packed, b), flush=flush,
                      reps=10, warmup=1)
    lib = library_call(b)
    lib_ms = time_cuda(lambda: lib(packed), flush=flush) if lib else None
    bms, by = bound_ms(n, b)
    return {"b": b, "n": n, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "gb_per_s": n * (b + 4) / (ms * 1e-3) / 1e9}


def phase_kernel_checks(large_log2: int) -> list:
    """Phase 3: kernel vs plain version on the card, bit-exact."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n_cases = 0
    for b in (1, 2, 3, 4):
        for n in (1, 127, 128, 1000, 40000):
            p = random_packed(n, b, gen)
            assert torch.equal(compbin_decode(p, b), compbin_decode_ref(p, b)), \
                (b, n)
            n_cases += 1
        # a base pointer that is not 4-byte aligned (byte-wise path)
        for shift in (1, 2, 3):
            p = random_packed(1001, b, gen)[shift:]
            p = p[: (p.numel() // b) * b]
            assert p.data_ptr() % 4 == shift and p.is_contiguous()
            assert torch.equal(compbin_decode(p, b), compbin_decode_ref(p, b)), \
                ("misaligned", b, shift)
            n_cases += 1
    for b in (5, 6, 7, 8):      # wide ids whose high bytes are zero
        n = 4099
        p = random_packed(n, b, gen).reshape(n, b)
        p[:, 4:] = 0
        p[:, 3] &= 0x7F          # stay inside int32
        want = compbin_decode_ref(p[:, :4].contiguous().reshape(-1), 4)
        assert torch.equal(compbin_decode(p.reshape(-1), b), want), b
        p[n // 2, 4] = 1         # one non-zero high byte must raise
        try:
            compbin_decode(p.reshape(-1), b)
        except ValueError:
            pass
        else:
            raise AssertionError(f"b={b}: non-zero high byte did not raise")
        n_cases += 2
    torch.cuda.synchronize()
    log(f"[kernel] {n_cases} small/misaligned/wide cases equal the plain "
        f"version bit for bit (torch.equal)")

    flush = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
    rows = []
    n = 1 << large_log2
    for b in (1, 2, 3, 4):
        p = random_packed(n, b, gen)
        r = measure_kernel(p, b, flush)
        del p
        torch.cuda.empty_cache()
        lib = ("none: no single PyTorch call decodes 3-byte ids"
               if r["library_ms"] is None and b == 3 else
               "none" if r["library_ms"] is None else
               f"{r['library_ms']:.4f}")
        log(f"[kernel] b={b} n=2^{large_log2}: kernel {r['ms']:.4f} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
            f"{r['gb_per_s']:.1f} GB/s  plain {r['plain_ms']:.4f} ms  "
            f"library_ms {lib}  max_abs_err {r['max_abs_err']}")
        rows.append(r)
    return rows


def _k2_close(got: torch.Tensor, want: torch.Tensor, dtype,
              what: str = "") -> float:
    rtol, atol = K2_TOL[dtype]
    assert got.dtype == torch.float32 and got.shape == want.shape, \
        (what, got.shape, want.shape)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    assert torch.allclose(got, want, rtol=rtol, atol=atol), \
        f"segment_sum {what} != plain version (max abs err {err})"
    return err


def served_tree_ids(n_seeds: int, fanouts=(5, 5), p_valid: float = 0.7,
                    seed: int = 0) -> tuple[np.ndarray, int]:
    """``edge_dst`` (int32) and node count of a padded tree block of
    ``n_seeds`` seeds as the GCN server lays them out
    (:func:`repro_torch.launch.data_gnn.block_to_edges`): ascending, with
    -1 holes.  A slot is valid with probability ``p_valid`` where its
    parent is (0.7 gives the ~53 % of valid slots the served blocks
    have)."""
    from types import SimpleNamespace
    from repro_torch.launch.data_gnn import block_to_edges
    rng = np.random.default_rng(seed)
    valid = [np.ones(n_seeds, bool)]
    for f in fanouts:
        valid.append(np.repeat(valid[-1], f)
                     & (rng.random(valid[-1].size * f) < p_valid))
    block = SimpleNamespace(layer_nodes=[np.zeros(v.size, np.int64)
                                         for v in valid],
                            layer_valid=valid, fanouts=tuple(fanouts))
    _, dst, n = block_to_edges(block)
    return dst.astype(np.int32), n


#: (E, D, N) of the JAX package's segment-sum sweep, and N > 8192
K2_SWEEP = ((64, 16, 4), (513, 200, 7), (2048, 128, 1024), (100, 1, 100),
            (1, 8, 1), (40000, 24, 20000))
#: int64 ids that narrowing to int32 would wrap into [0, N)
WIDE_IDS = (2 ** 32, 2 ** 32 + 5, -2 ** 32 + 3, 2 ** 31)
#: the id layouts every K2 design is held to (:func:`k2_layout`)
K2_LAYOUTS = ("served", "sorted", "permuted", "all_invalid", "one_segment",
              "ids_ge_n", "many_segments", "no_edges", "wide")


def k2_layout(kind: str, rng: np.random.Generator):
    """``(ids, n, d, exact)`` of one K2 check: ``served`` the tree layout
    at 64 seeds and Cora's width; ``sorted`` ascending ids with no hole;
    ``permuted`` the same ids shuffled; ``all_invalid`` -1 and ids >= N
    only; ``one_segment`` every edge into one row; ``ids_ge_n`` ascending
    over [-1, N+5); ``many_segments`` N = 20,000 (the TPU kernel's cliff
    is 8192); ``no_edges`` E = 0 with N*D > 0; ``wide`` ascending int64
    ids with :data:`WIDE_IDS` among them.  ``exact``: the messages are
    small integers, so every order of the adds gives the same f32 sum
    and the check is bit for bit (one row takes all E terms, whose
    rounding in f32 would otherwise grow with E)."""
    e, n, d, exact = 3000, 500, 67, False
    if kind == "served":
        ids, n = served_tree_ids(64, seed=int(rng.integers(1 << 30)))
        return ids, n, 1433, False
    if kind in ("sorted", "permuted"):
        n = 1200
        ids = np.sort(rng.integers(0, n, 5000))
        if kind == "permuted":
            ids = rng.permutation(ids)
    elif kind == "all_invalid":
        ids = rng.choice(np.array([-1, -5, n, n + 7]), e)
    elif kind == "one_segment":
        ids, n, exact = np.full(4000, 3), 10, True
    elif kind == "ids_ge_n":
        ids = np.sort(rng.integers(-1, n + 5, e))
    elif kind == "many_segments":
        n, d = 20000, 24
        ids = np.sort(rng.integers(-1, n, 40000))
    elif kind == "no_edges":
        ids, n = np.zeros(0), 37
    elif kind == "wide":
        ids = np.sort(rng.integers(-1, n, e))
        at = np.sort(rng.choice(e, 4 * len(WIDE_IDS), replace=False))
        ids[at] = np.tile(WIDE_IDS, 4)
        return ids.astype(np.int64), n, d, False
    else:
        raise ValueError(kind)
    return ids.astype(np.int32), n, d, exact


def _k2_messages(e: int, d: int, exact: bool, rng, device, dtype):
    a = (rng.integers(-8, 9, (e, d)) if exact
         else rng.standard_normal((e, d))).astype(np.float32)
    return torch.from_numpy(a).to(device, dtype)


def check_k2_determinism(device, n_seeds: int = 1024, d: int = 1433,
                         seed: int = 3) -> dict:
    """The ``rows`` design twice on the served layout (``n_seeds`` seeds,
    fanouts (5, 5), Cora's width by default): the two results must be
    equal bit for bit.  Also reports whether they equal the plain version
    run on the CPU bit for bit (both sum each row from +0.0 in edge
    order)."""
    ids_np, n = served_tree_ids(n_seeds, seed=seed)
    rng = np.random.default_rng(seed)
    msgs = _k2_messages(ids_np.size, d, False, rng, device, torch.float32)
    ids = torch.from_numpy(ids_np).to(device)
    first = _segment_sum_design(msgs, ids, n, "rows")
    second = _segment_sum_design(msgs, ids, n, "rows")
    equal = torch.equal(first, second)
    diff = 0 if equal else int((first != second).sum())
    assert equal, (f"segment_sum rows is not bit-identical across two "
                   f"calls on the served ids ({diff} elements differ)")
    cpu = segment_sum_ref(msgs.cpu(), ids.cpu(), n)
    return {"e": ids_np.size, "d": d, "n": n,
            "valid_edges": int((ids_np >= 0).sum()),
            "rows_equal_across_calls": True,
            "rows_equal_cpu_plain": bool(torch.equal(first.cpu(), cpu)),
            "max_abs_err_vs_cpu_plain": float(
                (first.cpu() - cpu).abs().max())}


def check_k2_backward(ids: torch.Tensor, n: int, d: int, dtype, rng,
                      what: str, *, offset: bool = False,
                      vecs=GRAD_VECS) -> int:
    """K2's backward on one layout, bit for bit against its plain version
    (a gather has no arithmetic): ``segment_sum_backward`` on f32
    ``grad_out[n, d]`` (with ``offset``, a view whose storage starts one
    float into its allocation, so only 4-byte vectors fit); the kernel at
    each width of ``vecs`` that D and the pointers allow, forced through
    ``_segment_sum_backward_vec``, and on the card each wider one refused
    with an error, never run narrower; autograd through ``segment_sum``
    on ``dtype`` messages (the grad in the messages' dtype); and an
    expanded (zero-stride) ``grad_out``, as ``.sum()`` hands one over.
    One count of ``segment_sum.grad_launches`` per call with work on the
    card, none on the CPU or for a refused width.  Returns the number of
    checks."""
    device = ids.device
    on_gpu = device.type == "cuda"
    e = ids.numel()
    launch = int(on_gpu and e * d > 0)
    grad_out = torch.from_numpy(rng.standard_normal((n, d)).astype(
        np.float32)).to(device, copy=True)      # the allocator's alignment
    if offset:
        grad_out = torch.cat([grad_out.new_zeros(1),
                              grad_out.flatten()])[1:].view(n, d)
    want = segment_sum_grad_ref(grad_out, ids, n)
    before = segment_sum.grad_launches
    got = segment_sum_backward(grad_out, ids, n)
    assert segment_sum.grad_launches == before + launch, what
    assert got.dtype == torch.float32 and got.shape == (e, d), got.shape
    assert torch.equal(got, want), \
        f"segment_sum backward on {what} != plain version"
    checks = 1
    widest = grad_vector_width(d, grad_out, got)
    for vec in vecs:
        before = segment_sum.grad_launches
        if vec > widest:
            if launch:
                try:
                    _segment_sum_backward_vec(grad_out, ids, n, vec)
                    refused = False
                except RuntimeError:
                    refused = True
                assert refused and segment_sum.grad_launches == before, \
                    (f"segment_sum backward at VEC {vec} on {what}: a width "
                     f"wider than {widest} was not refused")
                checks += 1
            continue
        got = _segment_sum_backward_vec(grad_out, ids, n, vec)
        assert segment_sum.grad_launches == before + launch, (what, vec)
        assert torch.equal(got, want), \
            f"segment_sum backward at VEC {vec} on {what} != plain version"
        checks += 1
    msgs = _k2_messages(e, d, False, rng, device, dtype).requires_grad_()
    out = segment_sum(msgs, ids, n)
    assert out.requires_grad or not on_gpu, what
    if out.requires_grad:
        before = segment_sum.grad_launches
        out.backward(grad_out)
        assert segment_sum.grad_launches == before + launch, what
        assert msgs.grad.dtype == dtype, msgs.grad.dtype
        assert torch.equal(msgs.grad, want.to(dtype)), \
            f"segment_sum autograd on {what} != plain version"
        checks += 1
    if n and d:
        row = grad_out[:1].expand(n, d)
        assert torch.equal(segment_sum_backward(row, ids, n),
                           segment_sum_grad_ref(row.contiguous(), ids, n)), \
            f"segment_sum backward on {what} with an expanded grad_out"
        checks += 1
    return checks


#: widths of K2's backward checks beyond the layouts': each vector width
#: (16 and 2 take 4 and 2 floats), odd widths, Cora's
K2_GRAD_WIDTHS = (1, 2, 3, 5, 16, 67, 1433)


def phase_segment_sum_checks(device="cuda", seed: int = 2,
                             n_seeds: int = 1024) -> dict:
    """K2 vs its plain version: each design (forced through
    ``_segment_sum_design``) and the public path on the JAX package's
    sweep shapes (:data:`K2_SWEEP`, random ids over [-1, N) and [-1, N+3))
    and on every layout of :data:`K2_LAYOUTS`, in f32 and bf16, within
    ``K2_TOL`` (bit for bit where the layout is exact); one call-count of
    ``segment_sum.launches`` per call that has work; E = 0, N = 0 and
    D = 0 giving zeros of the right shape; K2's backward bit for bit on
    every case and at every vector width it allows, and at
    :data:`K2_GRAD_WIDTHS` with ``grad_out`` aligned and one float off
    (:func:`check_k2_backward`); then the ``rows`` design's
    determinism on the served ids (:func:`check_k2_determinism`)."""
    on_gpu = torch.device(device).type == "cuda"
    rng = np.random.default_rng(seed)
    cases = [(f"sweep E={e} D={d} N={n} ids<{hi}",
              rng.integers(-1, hi, e).astype(np.int32), n, d, False)
             for e, d, n in K2_SWEEP for hi in (n, n + 3)]
    cases += [(kind,) + k2_layout(kind, rng) for kind in K2_LAYOUTS]
    n_cases = n_grad = 0
    for kind, ids_np, n, d, exact in cases:
        e = ids_np.size
        ids = torch.from_numpy(ids_np).to(device)
        for dtype in (torch.float32, torch.bfloat16):
            n_grad += check_k2_backward(ids, n, d, dtype, rng,
                                        f"{kind} ({str(dtype)[6:]})")
            msgs = _k2_messages(e, d, exact, rng, device, dtype)
            want = segment_sum_ref(msgs, ids, n)
            picked = k2_plan(e, d, n)
            for name, design in [(m, m) for m in K2_DESIGNS] + [
                    (f"public ({picked})", picked)]:
                before = segment_sum.launches
                got = (segment_sum(msgs, ids, n) if name.startswith("public")
                       else _segment_sum_design(msgs, ids, n, design))
                work = n * d if design == "rows" else e * d * n
                assert segment_sum.launches == before + int(
                    on_gpu and work > 0), (kind, name)
                what = f"{name} on {kind} ({str(dtype)[6:]})"
                if exact:
                    assert torch.equal(got, want), \
                        f"segment_sum {what} != plain version (exact layout)"
                else:
                    _k2_close(got, want, dtype, what)
                n_cases += 1
    for d in K2_GRAD_WIDTHS:
        ids = torch.from_numpy(rng.integers(-1, 503, 3000).astype(
            np.int32)).to(device)
        for offset in (False, True):
            n_grad += check_k2_backward(
                ids, 500, d, torch.float32, rng,
                f"D={d}{' (grad_out one float off)' if offset else ''}",
                offset=offset)
    for e, d, n in ((0, 8, 5), (7, 8, 0), (7, 0, 5)):
        msgs = torch.ones(e, d, device=device)
        ids = torch.zeros(e, dtype=torch.int32, device=device)
        for design in K2_DESIGNS:
            got = _segment_sum_design(msgs, ids, n, design)
            assert got.shape == (n, d) and not got.any(), (design, e, d, n)
            n_cases += 1
    det = check_k2_determinism(device, n_seeds)
    _cuda_sync(device)
    return {"cases": n_cases, "backward_checks": n_grad,
            "layouts": list(K2_LAYOUTS), "determinism": det}


def k2_bytes(e: int, d: int, n: int, valid: int) -> int:
    """Bytes one segment sum must move on this data: the ``valid`` rows
    of f32 messages (a row whose id is dropped need not be read) and all
    E int32 ids read, the N*D f32 sums written."""
    return 4 * valid * d + 4 * e + 4 * n * d


def k2_bound_ms(e: int, d: int, n: int, valid: int) -> tuple[float, str]:
    """Least time for one segment sum: :func:`k2_bytes` over HBM
    bandwidth, or one add per valid message element over the f32 rate,
    whichever is larger."""
    t_bytes = k2_bytes(e, d, n, valid) / HBM_BYTES_PER_S * 1e3
    t_ops = valid * d / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure_segment_sum(ids: torch.Tensor, d: int, n: int, flush,
                        gen: torch.Generator) -> dict:
    """K2 at one main-path shape: random f32 messages over ``ids`` (the
    served block's ``edge_dst``, or a permutation of it).  Each design
    against the plain version, its CUDA-event time and its CUDA launches
    per call (the profiler around one call: K2's kernels with each one's
    device time, and all kernels, the atomic design's zero-fill among
    them; the trace's L2 is warm); then the plain
    version's and the library call's (``zeros(N, D).index_add_`` on the
    valid edges) times, and the design :func:`plan` picks."""
    e = ids.numel()
    msgs = torch.randn(e, d, generator=gen, device="cuda")
    want = segment_sum_ref(msgs, ids, n)
    designs = {}
    for design in K2_DESIGNS:
        def call(m=design):
            return _segment_sum_design(msgs, ids, n, m)
        err = _k2_close(call(), want, torch.float32, f"{design} (timed)")
        counted = cuda_launches(call, "k2_") or (None, None, None)
        designs[design] = {
            "ms": time_cuda(call, flush=flush), "max_abs_err": err,
            "k2_launches_per_call": counted[0],
            "cuda_launches_per_call": counted[1],
            "kernel_device_ms": counted[2]}
    del want
    torch.cuda.synchronize()
    plain = time_cuda(lambda: segment_sum_ref(msgs, ids, n), flush=flush)
    valid = (ids >= 0) & (ids < n)
    lib_ids, lib_msgs = ids[valid].long(), msgs[valid]
    lib = time_cuda(lambda: torch.zeros(n, d, device="cuda").index_add_(
        0, lib_ids, lib_msgs), flush=flush)
    n_valid = int(valid.sum())
    bms, by = k2_bound_ms(e, d, n, n_valid)
    picked = k2_plan(e, d, n)
    nbytes = k2_bytes(e, d, n, n_valid)
    return {"e": e, "d": d, "n": n, "valid_edges": n_valid,
            "design": picked, "designs": designs,
            "max_abs_err": designs[picked]["max_abs_err"],
            "ms": designs[picked]["ms"], "plain_ms": plain,
            "library_ms": lib, "bound_ms": bms, "bound_by": by,
            "bytes": nbytes,
            "gb_per_s": nbytes / (designs[picked]["ms"] * 1e-3) / 1e9}


def measure_segment_sum_full_graph(ids: torch.Tensor, n: int, widths,
                                   flush, gen: torch.Generator) -> dict:
    """K2's forward over ``ids`` into ``n`` segments for each D of
    ``widths``: the full-graph training shapes (the full graph's
    unsorted ``edge_dst``, E > ``ROWS_MAX_EDGES``; layer 0, layer 1, the
    degrees) and ``[gnn2]``'s (:func:`gnn2_k2_shapes`).  The messages
    are small integers, so every order of the adds gives the same f32
    sums and each design is held to the plain version bit for bit.  Per
    width: both designs' CUDA-event ms, the plain version's ms,
    ``zeros(N, D).index_add_``'s (given the messages themselves when
    every id is valid: ``msgs[valid]`` would be a second 22.6 GB copy at
    D = 1433), the bound, the rate of ``plan``'s design, and the faster
    design (recorded beside ``plan``'s, not asserted).  Each result is
    freed before the next call, so the peak (reported) stays near two
    copies of the messages."""
    e = ids.numel()
    valid = (ids >= 0) & (ids < n)
    n_valid = int(valid.sum())
    lib_ids = ids[valid].long()
    out = {}
    torch.cuda.reset_peak_memory_stats()
    for d in widths:
        msgs = torch.randint(-8, 9, (e, d), generator=gen, device="cuda",
                             dtype=torch.float32)
        lib_msgs = msgs if n_valid == e else msgs[valid]
        want = segment_sum_ref(msgs, ids, n)

        def lib():
            return torch.zeros(n, d, device="cuda").index_add_(
                0, lib_ids, lib_msgs)

        assert torch.equal(lib(), want), f"index_add_ at D={d} != plain"
        designs = {}
        for design in K2_DESIGNS:
            def call(m=design):
                return _segment_sum_design(msgs, ids, n, m)
            assert torch.equal(call(), want), \
                f"segment_sum {design} at the full-graph D={d} != plain"
            designs[design] = {"ms": time_cuda(call, flush=flush)}
        del want
        plain = time_cuda(lambda: segment_sum_ref(msgs, ids, n), flush=flush)
        lib_ms = time_cuda(lib, flush=flush)
        del msgs, lib_msgs
        torch.cuda.empty_cache()
        picked = k2_plan(e, d, n)
        fastest = min(designs, key=lambda m: designs[m]["ms"])
        bms, by = k2_bound_ms(e, d, n, n_valid)
        nbytes = k2_bytes(e, d, n, n_valid)
        out[d] = {"e": e, "d": d, "n": n, "valid_edges": n_valid,
                  "design": picked, "fastest": fastest, "designs": designs,
                  "ms": designs[picked]["ms"], "plain_ms": plain,
                  "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                  "bytes": nbytes, "max_abs_err": 0.0,
                  "gb_per_s": nbytes / (designs[picked]["ms"] * 1e-3) / 1e9}
    return {"widths": out,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def k2_grad_bound_ms(e: int, d: int, rows: int,
                     id_bytes: int) -> tuple[float, str]:
    """Least time for K2's backward on this data: each of the ``rows``
    distinct rows of f32 ``grad_out`` that a valid id names read once (a
    row named twice need not be read twice, a dropped id reads nothing),
    the E x D f32 gradient written and the E ids read, over HBM
    bandwidth; it does no arithmetic."""
    return (4 * rows * d + 4 * e * d + e * id_bytes) / HBM_BYTES_PER_S \
        * 1e3, "bytes"


def measure_segment_sum_grad(ids: torch.Tensor, d: int, n: int, flush,
                             gen: torch.Generator) -> dict:
    """K2's backward at one training shape: random f32 ``grad_out[n, d]``
    gathered by ``ids``; the kernel bit for bit against its plain version,
    the vector width it took, its CUDA-event time, the plain
    version's time and the library calls' on the valid ids: the same
    gather as ``grad_out.index_select(0, ids)``, ``grad_out[ids]`` and
    ``embedding(ids, grad_out)``, each checked against the plain version;
    ``library_ms`` is the fastest and ``library_call`` names it."""
    e = ids.numel()
    grad_out = torch.randn(n, d, generator=gen, device="cuda")

    def call():
        return segment_sum_backward(grad_out, ids, n)

    got = call()
    assert torch.equal(got, segment_sum_grad_ref(grad_out, ids, n)), \
        "segment_sum backward (timed shape) != plain version"
    vec = grad_vector_width(d, grad_out, got)
    del got
    ms = time_cuda(call, flush=flush)
    plain = time_cuda(lambda: segment_sum_grad_ref(grad_out, ids, n),
                      flush=flush)
    valid = (ids >= 0) & (ids < n)
    lib_ids = ids[valid]
    libraries = {
        "grad_out.index_select(0, ids)":
            lambda: grad_out.index_select(0, lib_ids),
        "grad_out[ids]": lambda: grad_out[lib_ids],
        "embedding(ids, grad_out)":
            lambda: torch.nn.functional.embedding(lib_ids, grad_out)}
    want = segment_sum_grad_ref(grad_out, lib_ids, n)
    for name, lib in libraries.items():     # the yardsticks agree
        assert torch.equal(lib(), want), f"{name} != plain version"
    del want
    lib_ms = {name: time_cuda(lib, flush=flush)
              for name, lib in libraries.items()}
    best = min(lib_ms, key=lib_ms.get)
    n_valid = int(valid.sum())
    rows = int(torch.unique(lib_ids).numel())
    bms, by = k2_grad_bound_ms(e, d, rows, ids.element_size())
    nbytes = bms * 1e-3 * HBM_BYTES_PER_S
    return {"e": e, "d": d, "n": n, "valid_edges": n_valid,
            "grad_rows_read": rows, "vec": vec, "ms": ms, "plain_ms": plain,
            "library": lib_ms, "library_ms": lib_ms[best],
            "library_call": best, "bound_ms": bms,
            "bound_by": by, "max_abs_err": 0.0, "bytes": nbytes,
            "gb_per_s": nbytes / (ms * 1e-3) / 1e9}


def check_k2_plan_picks_the_faster(shapes: dict) -> None:
    """``plan``'s design at each timed shape (:func:`measure_segment_sum`
    results by label) must be the one measured faster there."""
    for label, r in shapes.items():
        fastest = min(r["designs"], key=lambda m: r["designs"][m]["ms"])
        assert r["design"] == fastest, \
            (f"plan picks {r['design']} at {label}, but {fastest} was "
             f"faster: {r['designs']}")


def phase_k2_plan_limits(ids: torch.Tensor, n: int, flush,
                         gen: torch.Generator) -> dict:
    """Both K2 designs on either side of ``plan``'s limits
    (``ROWS_MIN_WIDTH``, ``ROWS_MAX_EDGES``): across D on the served ids
    and on ascending ids drawn uniformly over [-1, E) with E = N = 2^17;
    across E at Cora's width on such uniform ids.  CUDA-event ms of each
    design, and the design ``plan`` picks."""
    def both(x, nn, d):
        msgs = torch.randn(x.numel(), d, generator=gen, device="cuda")
        row = {m: time_cuda(lambda m=m: _segment_sum_design(msgs, x, nn, m),
                            flush=flush, reps=5) for m in K2_DESIGNS}
        row["plan"] = k2_plan(x.numel(), d, nn)
        del msgs
        torch.cuda.empty_cache()
        return row

    def uniform(e):
        return torch.sort(torch.randint(-1, e, (e,), device="cuda",
                                        generator=gen, dtype=torch.int32))[0]

    out = {"width_served": {}, "width_uniform_2^17": {}, "edges_d1433": {}}
    wide = uniform(1 << 17)
    for d in (256, 384, 448, 512, 640, 768, 1024):
        out["width_served"][d] = both(ids, n, d)
        out["width_uniform_2^17"][d] = both(wide, 1 << 17, d)
    for le in (18, 20, 21):
        out["edges_d1433"][f"2^{le}"] = both(uniform(1 << le), 1 << le, 1433)
    return out


def _k3_close(got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    tol = K3_TOL[dtype]
    assert got.dtype == dtype and got.shape == want.shape, (got.shape,
                                                            want.shape)
    err = float((got.float() - want).abs().max()) if got.numel() else 0.0
    assert torch.allclose(got.float(), want, rtol=tol, atol=tol), \
        f"flash_attention kernel != plain version (max abs err {err})"
    return err


def _k3_inputs(b, hq, hkv, sq, skv, dh, dtype, gen):
    """q, k, v as the JAX package's sweep draws them (q and k scaled by
    0.3), made on the card."""
    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    return ((rand(b, hq, sq, dh) * 0.3).to(dtype),
            (rand(b, hkv, skv, dh) * 0.3).to(dtype),
            rand(b, hkv, skv, dh).to(dtype))


def decode_view(gen, dtype=torch.bfloat16, b: int = 8, live: int = 1087,
                hq: int = 15, hkv: int = 5, dh: int = 64, sq: int = 1):
    """A decode step (default: the served model's last, bf16): q [b, sq,
    hq, dh] and the ``live`` positions of a [b, live + 1, hkv, dh] cache
    as strided views."""
    ck = torch.randn(b, live + 1, hkv, dh, generator=gen, device="cuda") * 0.3
    cv = torch.randn(b, live + 1, hkv, dh, generator=gen, device="cuda")
    q = torch.randn(b, sq, hq, dh, generator=gen, device="cuda") * 0.3
    return q.to(dtype), ck.to(dtype)[:, :live], cv.to(dtype)[:, :live]


def _design(q: torch.Tensor, hkv: int, sq: int, kv_len: int) -> str:
    """The design ``plan`` gives a call with q in the JAX layout."""
    b, hq, _, dh = q.shape
    return plan(q.dtype, hq // hkv * sq, kv_len, dh, b * hkv)[0]


def phase_flash_checks() -> dict:
    """K3 vs its plain version on the card, across its three designs: the
    seven cases of the JAX package's sweep in f32, its bf16 case, Dh = 128
    in qwen2's head layout (12 over 2), Sq > Skv (fully masked rows must
    be 0), the served prefill, a decode step against a strided cache
    view; the tensor-core prefill at row counts either side of its
    64-row warpgroup and 128-row block edges (Dh 64 and 128, causal and
    full, Sq > Skv); split decode on strided cache views at kv_len 1, 65
    and 4096 in f32 and bf16, at 32 rows, and a 5-token chunk whose later
    key ranges see no key; then the refusal of a tensor that requires
    grad."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(2, 4, 2, 256, 256, 64, True, f32),
             (1, 8, 8, 128, 128, 128, True, f32),
             (1, 4, 1, 1, 384, 64, True, f32),
             (2, 6, 3, 100, 100, 64, True, f32),
             (1, 2, 2, 64, 256, 64, True, f32),
             (1, 2, 2, 128, 128, 64, False, f32),
             (1, 15, 5, 64, 64, 64, True, f32),
             (1, 4, 2, 128, 128, 64, True, bf16),
             (2, 12, 2, 300, 300, 128, True, f32),
             (2, 12, 2, 300, 300, 128, True, bf16),
             (1, 4, 2, 40, 16, 64, True, f32),
             (8, 15, 5, 1024, 1024, 64, True, bf16)]
    for dh in (64, 128):
        cases += [(1, 2, 2, sq, sq, dh, True, bf16) for sq in (63, 65, 129)]
        cases += [(1, 2, 2, 300, 300, dh, False, bf16),
                  (1, 3, 1, 100, 60, dh, True, bf16)]
    errs, designs = {}, set()
    for b, hq, hkv, sq, skv, dh, causal, dtype in cases:
        q, k, v = _k3_inputs(b, hq, hkv, sq, skv, dh, dtype, gen)
        before = flash_attention.launches
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        design = _design(q, hkv, sq, skv)
        designs.add(design)
        key = f"{b}x{hq}/{hkv}x{sq}x{skv}x{dh}{'' if causal else ' full'} " \
              f"{str(dtype).split('.')[-1]} {design}"
        errs[key] = _k3_close(got, attention_ref(q, k, v, causal=causal),
                              dtype)
        if sq > skv:
            assert not got[:, :, :sq - skv].any(), "masked rows are not 0"
    views = [(8, 15, 5, 1, 1087, 1086, bf16)]
    for dtype in (f32, bf16):
        views += [(2, 6, 2, 1, live, live - 1, dtype)
                  for live in (1, 65, 4096)]
        views += [(2, 32, 1, 1, 700, 699, dtype),       # 32 rows
                  (2, 6, 2, 5, 1000, 40, dtype)]        # empty later ranges
    for b, hq, hkv, sq, live, offset, dtype in views:
        q, k, v = decode_view(gen, dtype, b, live, hq, hkv, sq=sq)
        assert not k.is_contiguous()
        got = attention_bshd(q, k, v, offset=offset, kv_len=live)
        torch.cuda.synchronize()
        want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), offset=offset,
                             kv_len=live).transpose(1, 2)
        design, nsplit = plan(dtype, hq // hkv * sq, live, 64, b * hkv)
        designs.add(design)
        errs[f"view {b}x{hq}/{hkv}x{sq} over {live} (offset {offset}) "
             f"{str(dtype).split('.')[-1]} {design} x{nsplit}"] = \
            _k3_close(got, want, dtype)
    assert designs == {"tc_prefill", "fma", "split_decode"}, designs
    try:
        flash_attention(*(t.float().requires_grad_()
                          for t in _k3_inputs(1, 2, 2, 8, 8, 64, f32, gen)))
    except RuntimeError:
        pass
    else:
        raise AssertionError("a CUDA tensor that requires grad did not raise")
    log(f"[kernel] flash_attention: {len(errs)} cases within f32 "
        f"{K3_TOL[f32]} / bf16 {K3_TOL[bf16]} (rtol and atol) of the plain "
        f"version, designs {sorted(designs)}; Sq > Skv rows are 0; "
        f"requires_grad raises; max abs err "
        + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()))
    return errs


def k3_work(b, hq, hkv, sq, dh, kv_len, offset,
            elem: int = 2) -> tuple[int, float]:
    """(bytes, flops) one causal attention call must move and do on this
    data (``elem`` bytes per element): q, the live K/V and o once each;
    4*Dh flops per visible (query, key) pair and head (QK^T and PV)."""
    nbytes = elem * (2 * b * hq * sq * dh + 2 * b * hkv * kv_len * dh)
    pairs = int(np.clip(np.arange(sq) + offset + 1, 0, kv_len).sum())
    return nbytes, 4.0 * b * hq * dh * pairs


def k3_bound_ms(nbytes: int, flops: float,
                ops_per_s: float = BF16_OPS_PER_S) -> tuple[float, str]:
    """Least time for one call: bytes over HBM bandwidth or flops over
    the peak for the operand type (bf16 tensor cores by default; f32 runs
    at the CUDA cores' rate), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: K3's timed shapes, one per design: smollm-360m's served prefill and
#: last decode step (bf16), and the f32 correctness run's prefill (batch
#: 2 x 512) and its last decode step (519 live positions)
K3_SHAPES = {
    "prefill": dict(dtype=torch.bfloat16, b=8, s=1024),
    "decode": dict(dtype=torch.bfloat16, b=8, live=1087),
    "prefill_f32": dict(dtype=torch.float32, b=2, s=512),
    "decode_f32": dict(dtype=torch.float32, b=2, live=519),
}


def launches_per_call(events, prefix: str, calls: int) -> tuple:
    """``(mine, all, device_ms)`` per call from the ``key_averages()`` of
    a trace of ``calls`` calls: the CUDA kernels whose name holds
    ``prefix`` (``k2_``, ``k3_``: the kernel's own), all CUDA kernels,
    and the device milliseconds a call of each of the kernel's own by
    name.  The schedule's own ``ProfilerStep*`` span, which the trace
    also shows on the device, is not a launch.  Each total must divide
    evenly by ``calls``: a trace that lost some of a call's kernels fails
    here rather than report a fraction."""
    import re
    device = [ev for ev in events
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and not ev.key.startswith("ProfilerStep")]
    mine = [ev for ev in device if prefix in ev.key]
    assert mine, (f"no {prefix} kernel in the trace: "
                  f"{[ev.key for ev in device]}")
    n_mine = sum(ev.count for ev in mine)
    n_all = sum(ev.count for ev in device)
    assert n_mine % calls == 0 and n_all % calls == 0, \
        (f"{n_mine} {prefix} kernels and {n_all} in all in a trace of "
         f"{calls} calls")
    device_ms = {}
    for ev in mine:
        name = re.search(prefix + r"\w+", ev.key).group(0)
        device_ms[name] = (device_ms.get(name, 0.0)
                           + ev.device_time_total / 1e3 / calls)
    return n_mine // calls, n_all // calls, device_ms


#: calls counted in one profiler window (:func:`cuda_launches`)
TRACE_CALLS = 8


def cuda_launches(fn, prefix: str, attempts: int = 4) -> tuple | None:
    """CUDA kernels that one call of ``fn`` launches, from one
    ``torch.profiler`` window: one warm-up call traced and dropped (the
    schedule's warm-up step), then :data:`TRACE_CALLS` calls counted; per
    call, as :func:`launches_per_call` gives them.  A window of one short
    call often held no device event; a window that holds none or loses a
    call is traced again, up to ``attempts`` times.  None (not measured)
    is returned if no trace saw the card; if the last trace saw it but
    its totals do not divide by the calls, :func:`launches_per_call`
    raises.  Late in a full run, after ``[train]``, windows lost kernels
    in every retry (5 of 8 calls); :func:`fresh_k2_grad_launches` counts
    there in a new process."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(TRACE_CALLS):
                fn()
            torch.cuda.synchronize()
            prof.step()
        events = prof.key_averages()
        if not any(ev.device_type == cuda for ev in events):
            continue
        try:
            return launches_per_call(events, prefix, TRACE_CALLS)
        except AssertionError:
            if attempt == attempts - 1:
                raise
    return None


#: run by :func:`fresh_k2_launches` in a new Python process: argv[1]
#: this file, argv[2] a JSON list of (label, ids .npy, N, D, backward),
#: argv[3] a JSON list of ``K3_FRESH_SHAPES`` kinds, argv[4] a JSON list
#: of K1 cases (label, n, b)
_FRESH_K2_LAUNCHES = """
import importlib.util, json, sys
import numpy as np, torch
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
out = {}
for label, path, n, d, backward in json.loads(sys.argv[2]):
    ids = torch.from_numpy(np.load(path)).cuda()
    if backward:
        grad = torch.randn(n, d, device="cuda")
        fn = lambda: cs.segment_sum_backward(grad, ids, n)
    else:
        msgs = torch.randn(ids.numel(), d, device="cuda")
        fn = lambda: cs.segment_sum(msgs, ids, n)
    out[label] = cs.cuda_launches(fn, "k2_")
gen = torch.Generator(device="cuda").manual_seed(0)
for kind in json.loads(sys.argv[3]):
    out[kind] = cs.cuda_launches(cs.flash_call(cs.K3_FRESH_SHAPES[kind], gen),
                                 "k3_")
for label, n, b in json.loads(sys.argv[4]):
    packed = cs.random_packed(n, b, gen)
    out[label] = cs.cuda_launches(lambda: cs.compbin_decode(packed, b),
                                  "decode_")
print(json.dumps(out))
"""


def fresh_k2_grad_launches(cases: dict, d: int, workdir: str) -> dict:
    """K2's backward's CUDA launches per call (:func:`cuda_launches`) at
    each case ``label -> (ids, n)`` of width ``d``:
    :func:`fresh_k2_launches`."""
    return fresh_k2_launches({label: (ids, n, d, True) for label, (ids, n)
                              in cases.items()}, workdir)


def fresh_k2_launches(cases: dict, workdir: str, k3_kinds=(),
                      k1_cases=None) -> dict:
    """K2's CUDA launches per call (:func:`cuda_launches`) at each case
    ``label -> (ids, n, d, backward)`` (the forward, or with ``backward``
    its gather), K3's at each of ``k3_kinds`` (``K3_FRESH_SHAPES``,
    :func:`flash_call`) and K1's at each of ``k1_cases`` (``label -> (n,
    b)``, random packed bytes), counted in a new Python process that loads the
    libraries this run built: late in this process the profiler lost
    kernel records (the same window in a fresh process counts every
    call).  The ids go over as ``.npy`` files in ``workdir``; the process
    is waited for."""
    args = []
    for label, (ids, n, d, backward) in cases.items():
        path = os.path.join(workdir, f"k2_ids_{label}.npy")
        np.save(path, ids.cpu().numpy())
        args.append((label, path, int(n), int(d), bool(backward)))
    done = subprocess.run(
        [sys.executable, "-c", _FRESH_K2_LAUNCHES,
         os.path.abspath(__file__), json.dumps(args),
         json.dumps(list(k3_kinds)),
         json.dumps([(label, int(n), int(b)) for label, (n, b)
                     in (k1_cases or {}).items()])],
        check=True, capture_output=True, text=True, timeout=300)
    return json.loads(done.stdout.strip().splitlines()[-1])


def flash_call(sh: dict, gen):
    """K3's call at one timed shape (``K3_SHAPES`` / ``MOE_K3_SHAPES``),
    on inputs drawn from ``gen``: a function of no arguments."""
    dtype, b = sh["dtype"], sh["b"]
    hq, hkv, dh = sh.get("hq", 15), sh.get("hkv", 5), sh.get("dh", 64)
    if "s" in sh:
        q, k, v = _k3_inputs(b, hq, hkv, sh["s"], sh["s"], dh, dtype, gen)
        return lambda: flash_attention(q, k, v)
    q, k, v = decode_view(gen, dtype, b, sh["live"], hq, hkv, dh)
    return lambda: attention_bshd(q, k, v, offset=sh["live"] - 1,
                                  kv_len=sh["live"])


def measure_flash(kind: str, flush, gen, shapes=None,
                  count_launches: bool = True) -> dict:
    """K3 at one of ``shapes`` (default ``K3_SHAPES``: smollm-360m's 15
    query over 5 KV heads of 64; a shape may name ``hq``, ``hkv`` and
    ``dh``, as ``MOE_K3_SHAPES`` do): the prefill as q [b,hq,s,dh] over
    k/v [b,hkv,s,dh], causal; the decode step as one query row per head
    against ``live`` positions of a [b, live+1, hkv, dh] cache view.  Kernel vs plain version, then
    kernel, plain and library-call times.  The library calls are
    ``scaled_dot_product_attention`` with ``enable_gqa=True`` and an
    explicit decode-convention mask and, where Sq == Skv, with
    ``is_causal=True`` (which aligns the mask top-left, the same function
    there, and may take a faster backend); ``library_ms`` is the faster
    of the two and ``library_call`` names it.  ``cuda_launches_per_call``
    is counted by the profiler around one call (:func:`cuda_launches`),
    unless ``count_launches`` is false (None: counted elsewhere)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sh = (shapes or K3_SHAPES)[kind]
    dtype, b = sh["dtype"], sh["b"]
    hq, hkv, dh = sh.get("hq", 15), sh.get("hkv", 5), sh.get("dh", 64)
    if "s" in sh:
        q, k, v = _k3_inputs(b, hq, hkv, sh["s"], sh["s"], dh, dtype, gen)
        qh, kh, vh = q, k, v
        offset, kv_len = 0, sh["s"]

        def kernel():
            return flash_attention(q, k, v)
    else:
        q, k, v = decode_view(gen, dtype, b, sh["live"], hq, hkv, dh)
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        kv_len = sh["live"]
        offset = kv_len - 1

        def kernel():
            return attention_bshd(q, k, v, offset=offset, kv_len=kv_len)
    sq = qh.shape[2]
    design, nsplit = plan(dtype, hq // hkv * sq, kv_len, dh, b * hkv)

    def plain():
        return attention_ref(qh, kh, vh, offset=offset, kv_len=kv_len)

    mask = (torch.arange(kv_len, device="cuda")[None, :]
            <= torch.arange(sq, device="cuda")[:, None] + offset)
    libraries = {"sdpa_explicit_mask": lambda: sdpa(
        qh, kh, vh, attn_mask=mask, enable_gqa=True)}
    if sq == kv_len:
        libraries["sdpa_is_causal"] = lambda: sdpa(
            qh, kh, vh, is_causal=True, enable_gqa=True)

    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    if "live" in sh:
        got = got.transpose(1, 2)
    err = _k3_close(got, want, dtype)
    for lib in libraries.values():          # the yardsticks agree
        _k3_close(lib(), want, dtype)
    del got, want
    counted = cuda_launches(kernel, "k3_") if count_launches else None
    launches = counted and counted[0]
    ms = time_cuda(kernel, flush=flush)
    plain_ms = time_cuda(plain, flush=flush)
    lib_ms = {name: time_cuda(lib, flush=flush)
              for name, lib in libraries.items()}
    best = min(lib_ms, key=lib_ms.get)
    elem = 2 if dtype == torch.bfloat16 else 4
    nbytes, flops = k3_work(b, hq, hkv, sq, dh, kv_len, offset, elem)
    bms, by = k3_bound_ms(nbytes, flops, BF16_OPS_PER_S if elem == 2
                          else FP32_OPS_PER_S)
    return {"kind": kind, "design": design, "nsplit": nsplit,
            "cuda_launches_per_call": launches,
            "dtype": str(dtype).split(".")[-1], "b": b, "hq": hq,
            "hkv": hkv, "sq": sq, "kv_len": kv_len, "dh": dh,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library": lib_ms, "library_ms": lib_ms[best],
            "library_call": best, "bound_ms": bms, "bound_by": by,
            "bytes": nbytes, "flops": flops,
            "gb_per_s": nbytes / (ms * 1e-3) / 1e9,
            "tflop_per_s": flops / (ms * 1e-3) / 1e12}


def phase_h2d(n_bytes: int = 64 << 20, reps: int = 5) -> dict:
    """Host-to-device copy rate of one staging-sized buffer, pageable (what
    the loader does today) against pinned memory."""
    out = {}
    for kind in ("pageable", "pinned"):
        host = torch.zeros(n_bytes, dtype=torch.uint8,
                           pin_memory=(kind == "pinned"))
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host.to("cuda", non_blocking=True)
            torch.cuda.current_stream().synchronize()
            times.append(time.perf_counter() - t0)
        out[kind + "_gb_per_s"] = n_bytes / statistics.median(times[1:]) / 1e9
    log(f"[h2d] {n_bytes >> 20} MiB host->device: pageable "
        f"{out['pageable_gb_per_s']:.2f} GB/s, pinned "
        f"{out['pinned_gb_per_s']:.2f} GB/s")
    return out


def phase_crossover(path: str, device) -> dict:
    """Phase 7: host vs device decode per batch edge mass, around
    ``policy.QUERY_DEVICE_MIN_EDGES`` (measured, the constant stays)."""
    rng = np.random.default_rng(7)
    rows = []
    with open_graph(path) as g, NeighborQueryEngine(
            g, decode="device", device=device) as eng:
        b, nv = g.bytes_per_id, g.n_vertices
        for log2 in range(8, 21):
            mass = 1 << log2
            span = 16                      # ids per adjacency run
            ids = rng.integers(0, nv, mass).astype("<u8")
            raw = ids.view(np.uint8).reshape(mass, 8)[:, :b].copy()
            packed = [raw[i:i + span].reshape(-1)
                      for i in range(0, mass, span)]
            reps = 20 if log2 <= 16 else 5
            host_t, dev_t = [], []
            for _ in range(reps):
                t0 = time.perf_counter()
                h, _ = eng._decode_host(packed)
                t1 = time.perf_counter()
                d, _ = eng._decode_device(packed)
                t2 = time.perf_counter()
                host_t.append(t1 - t0)
                dev_t.append(t2 - t1)
            assert all(np.array_equal(x, y) for x, y in zip(h, d))
            rows.append((mass, statistics.median(host_t),
                         statistics.median(dev_t)))
    crossover = None
    for i, (mass, ht, dt) in enumerate(rows):
        if all(d <= h for _, h, d in rows[i:]):
            crossover = mass
            break
    for mass, ht, dt in rows:
        log(f"[crossover] {mass:>8} edges: host {ht * 1e6:10.1f} us  "
            f"device {dt * 1e6:10.1f} us")
    log(f"[crossover] device decode is no slower than host from "
        f"{crossover} edges per batch on (spans of 16 ids, b={b}); "
        f"policy.QUERY_DEVICE_MIN_EDGES = {policy.QUERY_DEVICE_MIN_EDGES} "
        f"(unchanged)")
    return {"crossover_edges": crossover,
            "rows": [{"edges": m, "host_s": h, "device_s": d}
                     for m, h, d in rows]}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# [train]: gcn-cora training on the card (multi-host streamed load, K2
# forward and backward, AdamW, checkpoints with restart)
# ---------------------------------------------------------------------------

#: the first full-graph step on the kernel path against the plain path:
#: loss rtol; grads rtol and atol as a share of the largest |g| (K2's
#: atomic design adds in any order).  The restart is held to the grads'.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = (1e-4, 1e-6)
#: the restart's final params: the L2 distance from the uninjected run's
#: as a share of the distance that run moved them (:func:`check_restart`)
RESTART_PARAM_SHARE = 1e-2
#: StreamStats counters the cut between hosts cannot change: summed over
#: hosts they equal one host's (partitions, H2D padding and cache traffic
#: follow where the feature-aligned cuts fall, so they are reported only)
STREAM_DATA_COUNTERS = ("vertices", "edges", "host_decode_bytes",
                        "feature_rows", "feature_bytes",
                        "feature_bytes_h2d", "label_rows", "label_bytes")


#: ``[gnn2]``'s gradients against the plain path in float64: the kernel
#: path may lie this many times as far from them, relative to each
#: gradient's max|g|, as the f32 plain path lies at its worst over all
#: parameters (plus ``TRAIN_GRAD_TOL``'s share of max|g|).  PNA's std
#: aggregator's E[m^2] - E[m]^2 cancels, so either path's f32 gradients
#: carry ~1e-5 x max|g| of rounding (``tests/test_torch_gnn_models.py``
#: measures the JAX package's own: 1.2e-6 of a max|g| of 0.098);
#: MeshGraphNet's 15 residual layers carry the sums' order to an element
#: of edge_enc/l0_b 2.0e-3 apart where ``TRAIN_GRAD_TOL`` allows 3.0e-4
#: (NVIDIA H100 80GB HBM3, 700.00 W).  Both paths add in a random order on
#: the card, so the worst over all parameters, not each parameter's own
#: draw, sets the scale
EXACT_FACTOR = 2.0


@contextlib.contextmanager
def swapped_kernel_ops(sums, gathers):
    """Within the block the seams where the models ask for K2, each
    holding a function ``f``, hold ``sums(f)`` (``layers.segment_sum``,
    ``tf.segment_sum``) or ``gathers(f)`` (``layers.gather``)."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.gnn import layers

    saved = layers.segment_sum, tf.segment_sum, layers.gather
    layers.segment_sum, tf.segment_sum = sums(saved[0]), sums(saved[1])
    layers.gather = gathers(saved[2])
    try:
        yield
    finally:
        layers.segment_sum, tf.segment_sum, layers.gather = saved


@contextlib.contextmanager
def plain_segment_sum(fn=None):
    """Every segment sum of the GNNs and of the MoE combine on ``fn``
    (default: K2's plain version, autograd through ``index_add_``), and
    every GNN gather on its plain version (autograd through
    ``index_put_``, where the card's training step sums the gather's
    gradient on K2), on any device: the yardstick the kernel path is
    held against."""
    from repro_torch.models.gnn import layers

    with swapped_kernel_ops(lambda _: fn or segment_sum_ref,
                            lambda _: layers.gather_plain):
        yield


def _on_card(t: torch.Tensor) -> bool:
    """Whether the kernel ops take ``t`` to the card."""
    return t.is_cuda


@dataclasses.dataclass
class KernelRequests:
    """What the models asked of K2 on the card within
    :func:`kernel_requests`: ``sums``, segment sums with work (E x D x N
    > 0); ``grad_sums``, those of messages that need a gradient (grad
    mode on); ``grad_gathers``, gathers with work of such a tensor."""
    sums: int = 0
    grad_sums: int = 0
    grad_gathers: int = 0

    def launches(self) -> dict:
        """K2's launches these requests make: a forward one a sum and a
        gather's backward (``layers._Gather``), a ``k2_grad`` one a sum
        needing a gradient (``rows`` also launches on a sum of no
        edges, which no model asks for)."""
        return {"k2": self.sums + self.grad_gathers,
                "k2_grad": self.grad_sums}


@contextlib.contextmanager
def kernel_requests():
    """Counts in a :class:`KernelRequests` what the models ask of the K2
    ops within the block (:func:`swapped_kernel_ops`; not nested), every
    call run as it would be.  The sum a gather's backward makes is
    counted as the gather, where it was asked for."""
    from repro_torch.models.gnn import layers

    asked, lock = KernelRequests(), threading.Lock()
    gather_backward = inspect.unwrap(layers._Gather.backward).__code__

    def sums(real):
        def counted(messages, segment_ids, num_segments):
            if messages.numel() * num_segments and \
                    sys._getframe(1).f_code is not gather_backward and \
                    _on_card(messages):
                with lock:
                    asked.sums += 1
                    asked.grad_sums += messages.requires_grad and \
                        torch.is_grad_enabled()
            return real(messages, segment_ids, num_segments)
        return counted

    def gathers(real):
        def counted(x, idx):
            if x.requires_grad and torch.is_grad_enabled() and \
                    idx.numel() * x.numel() and _on_card(x):
                with lock:
                    asked.grad_gathers += 1
            return real(x, idx)
        counted.__dict__ = real.__dict__  # _Gather bumps grad_launches here
        return counted

    with swapped_kernel_ops(sums, gathers):
        yield asked


@contextlib.contextmanager
def k2_as_asked(what: str):
    """K2's forward and backward launches within the block equal those
    its counted requests make (:func:`kernel_requests`; none on the
    CPU); yields the :class:`KernelRequests`."""
    c0 = kernel_counts()
    with kernel_requests() as asked:
        yield asked
    want, got = asked.launches(), _count_delta(c0)
    assert {k: got[k] for k in want} == want, \
        f"{what}: K2 launches {got} != its requests' {want}"


def add_k2(out: dict, *launches: dict) -> None:
    """Adds checked blocks' K2 launches (:meth:`KernelRequests.launches`)
    to ``out``'s ``k2_launches`` and ``k2_grad_launches``."""
    for x in launches:
        for k, n in x.items():
            out[f"{k}_launches"] = out.get(f"{k}_launches", 0) + n


def segment_sum_f64(messages: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """:func:`segment_sum_ref` in float64 (ids outside [0, N) dropped):
    the segment sum of the float64 plain path."""
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    out = torch.zeros(num_segments, messages.shape[1], dtype=torch.float64,
                      device=messages.device)
    return out.index_add_(0, torch.where(valid, segment_ids, 0).long(),
                          torch.where(valid[:, None], messages.double(), 0.0))


def flat_tree(tree, prefix: str = "") -> dict:
    """A nested params dict as ``{"a/b": leaf}``, in ``tree_leaves``'
    (sorted-key) order."""
    if isinstance(tree, dict):
        return {kk: v for k in sorted(tree)
                for kk, v in flat_tree(tree[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def loss_and_grads(loss_fn, params) -> tuple[float, dict]:
    """``loss_fn(params)`` and its gradient by parameter, from detached
    leaves (``{path: grad}``, :func:`flat_tree`'s keys)."""
    p = tree_map(lambda v: v.detach().requires_grad_(), params)
    loss = loss_fn(p)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    return float(loss.detach()), dict(zip(flat_tree(p), grads))


def exact_plain_grads(mod, cfg, batch: dict, params):
    """:func:`first_step_parity`'s ``exact`` for a GNN module: its
    gradients on the plain path in float64 (the params and the config's
    dtype float64, every segment sum :func:`segment_sum_f64`)."""
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)

    def exact() -> dict:
        with plain_segment_sum(segment_sum_f64):
            return loss_and_grads(lambda p: mod.loss_fn(p, batch, cfg64),
                                  tree_map(torch.Tensor.double, params))[1]

    return exact


def train_close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """``got`` within ``TRAIN_GRAD_TOL`` of ``want``; returns the max abs
    error."""
    rtol, share = TRAIN_GRAD_TOL
    atol = share * float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert got.shape == want.shape and torch.allclose(
        got, want, rtol=rtol, atol=atol), \
        f"{what}: max abs err {err} beyond rtol {rtol}, atol {atol}"
    return err


def relative_distance(plain: dict, exact: dict) -> float:
    """The worst over parameters of ``plain``'s max abs distance from
    ``exact`` (float64) as a share of that parameter's max|exact|."""
    return max((float((plain[k].double() - x).abs().max())
                / float(x.abs().max())
                for k, x in exact.items() if x.numel() and x.abs().max()),
               default=0.0)


def exact_close(got: torch.Tensor, exact: torch.Tensor, scale: float,
                what: str) -> float:
    """``got`` within ``(EXACT_FACTOR * scale + TRAIN_GRAD_TOL[1]) x
    max|exact|`` of ``exact`` (the float64 plain path's), ``scale``
    being the f32 plain path's :func:`relative_distance`; returns
    ``got``'s max abs error against ``exact``."""
    if not exact.numel():
        return 0.0
    err = float((got.double() - exact).abs().max())
    bound = (EXACT_FACTOR * scale + TRAIN_GRAD_TOL[1]) \
        * float(exact.abs().max())
    assert got.shape == exact.shape and err <= bound, \
        f"{what}: max abs err {err} from float64 beyond {bound}"
    return err


def first_step_pair(loss_fn, params, plain_fn=None):
    """The loss and every gradient of ``loss_fn(params)`` on the kernel
    path and of ``plain_fn`` (default ``loss_fn``) on the plain path
    (:func:`plain_segment_sum`) on the same device: K2's launches on the
    kernel path as its requests ask (:func:`k2_as_asked`, recorded as
    ``launches``) and none on the plain path; the loss within
    ``TRAIN_LOSS_RTOL``.  Returns the record and both paths'
    gradients."""
    with k2_as_asked("first-step kernel path") as asked:
        loss_k, grads_k = loss_and_grads(loss_fn, params)
    with k2_as_asked("first-step plain path"), plain_segment_sum():
        loss_p, grads_p = loss_and_grads(plain_fn or loss_fn, params)
    assert abs(loss_k - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p), \
        f"first-step loss {loss_k} != plain path's {loss_p}"
    out = {"loss": loss_k, "plain_loss": loss_p,
           "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
           "launches": asked.launches()}
    return out, grads_k, grads_p


def first_step_parity(loss_fn, params, exact=None, plain_fn=None) -> dict:
    """:func:`first_step_pair`, then each gradient of the kernel path
    within ``TRAIN_GRAD_TOL`` (:func:`train_close`) of the plain path's
    or, given ``exact`` (a callable returning the float64 plain path's
    gradients by parameter), held to those by :func:`exact_close` at the
    f32 plain path's :func:`relative_distance`."""
    out, grads_k, grads_p = first_step_pair(loss_fn, params, plain_fn)
    if exact is None:
        out["grad_max_abs_err"] = {
            k: train_close(grads_k[k], grads_p[k], f"first-step grad {k}")
            for k in grads_p}
        return out
    grads_x = exact()
    scale = out["plain_relative_distance"] = relative_distance(grads_p,
                                                               grads_x)
    out["grad_max_abs_err_vs_f64"] = {
        k: exact_close(grads_k[k], grads_x[k], scale, f"first-step grad {k}")
        for k in grads_p}
    out["plain_max_abs_err_vs_f64"] = {
        k: float((grads_p[k].double() - grads_x[k]).abs().max())
        for k in grads_p if grads_p[k].numel()}
    return out


def param_drift(got: dict, want: dict, start: dict) -> dict:
    """How far ``got``'s params lie from ``want``'s, per param (nested
    dicts by their "a/b" paths): the max abs difference, and the L2
    distance as a share of the distance ``want`` moved from
    ``start``."""
    def paths(tree, prefix=""):         # in the params' own key order
        if isinstance(tree, dict):
            return {kk: v for k in tree
                    for kk, v in paths(tree[k], f"{prefix}{k}/").items()}
        return {prefix[:-1]: tree}

    out = {}
    got_p, start = paths(got["params"]), paths(start)
    for k, w in paths(want["params"]).items():
        w = w.float()
        moved = float((w - start[k].float()).norm())
        diff = got_p[k].float() - w
        out[k] = {"max_abs": float(diff.abs().max()),
                  "share": float(diff.norm()) / max(moved, 1e-30)}
    return out


def check_restart(resumed: dict, saved: dict, losses_after: list,
                  clean_losses: list, final: dict, clean: dict,
                  start: dict) -> dict:
    """The restart held to the uninjected run.  K2's atomic sums round in
    any order, and AdamW's ``m / sqrt(v)`` turns a near-zero gradient's
    last-bit noise into up to ``lr`` of movement, so two uninjected runs
    already differ element by element (``noise_floor``).  So: the state
    the trainer resumed from must equal the state it checkpointed bit
    for bit; every loss after the restore must equal the uninjected
    run's for the same step within ``TRAIN_LOSS_RTOL``; and each final
    param must lie within ``RESTART_PARAM_SHARE`` of the distance the
    uninjected run moved it (L2).  A lost or stale restore leaves the run
    a whole step off and fails all three."""
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(resumed), tree_leaves(saved))), \
        "the state the trainer resumed from is not the one it checkpointed"
    err = max(abs(a - b) / abs(b) for a, b in zip(losses_after,
                                                  clean_losses))
    assert len(losses_after) == len(clean_losses) and \
        err <= TRAIN_LOSS_RTOL, \
        f"losses after the restore {losses_after} != {clean_losses}"
    drift = param_drift(final, clean, start)
    for k, d in drift.items():
        assert d["share"] <= RESTART_PARAM_SHARE, \
            f"restored param {k} off the uninjected run's: {d}"
    return {"loss_rel_err": err, "drift": drift}


def _train_kernel_class(name: str) -> str:
    if "k2_grad" in name:
        return "k2_grad"
    return "k2" if "k2_" in name else _kernel_class(name)


def train_step_split(step, state, batch) -> dict:
    """Where one training step spends the card's time: device time by
    kernel class (K2's forward kernels, its backward ``k2_grad``, GEMMs,
    copies, other: the gathers and their backward, ``where``, PNA's
    ``index_reduce``, products, loss, AdamW) against the host-clock wall
    of the same step (:func:`profile_device`); None where the trace holds
    no device time; K2's launches, as the step's requests ask
    (:func:`k2_as_asked`)."""
    with k2_as_asked("profiled step") as asked:
        wall, sums, kernels = profile_device(
            lambda: step(state, batch), _train_kernel_class,
            ("k2", "k2_grad", "gemm", "copy", "other"))
    busy = sum(sums.values())
    return {"wall_ms": wall * 1e3, "device_ms": sums if busy else None,
            "idle_share": 1 - busy / (wall * 1e3) if busy else None,
            "top_kernels": sorted(kernels, reverse=True)[:8],
            "launches": asked.launches()}


def _timed_steps(step, state, batch, n: int, device) -> tuple:
    """``n`` steps from ``state`` on ``batch``, each launching K2 as its
    requests ask (:func:`k2_as_asked`): (state, losses, host-clock
    seconds a step to a synchronise, K2's launches a step)."""
    losses, secs, counts = [], [], []
    for i in range(n):
        t0 = time.perf_counter()
        with k2_as_asked(f"step {i}") as asked:
            state, met = step(state, batch)
        losses.append(float(met["loss"]))
        _cuda_sync(device)
        secs.append(time.perf_counter() - t0)
        counts.append(asked.launches())
    return state, losses, secs, counts


def phase_train(device, workdir: str, *, scale: int = 18,
                edge_factor: int = 16, hosts: int = 2, steps: int = 10,
                parity_scale: int = 16, sampled_steps: int = 16,
                sampled_seeds: int = 1024, fail_at: int = 5,
                ckpt_every: int = 4, reduced: bool = False,
                seed: int = 0) -> dict:
    """gcn-cora training through the port's training entry point
    (``repro_torch.launch.train``), full width unless ``reduced``:

    1. ``--full-graph --hosts N``'s load: the triplet of
       ``ensure_gnn_assets(scale, edge_factor)`` streamed by ``hosts``
       simulated hosts (feature-aligned cuts); the data counters of
       ``StreamStats`` summed over hosts equal one host's, no byte is
       decoded on the host, K1 launches once a partition;
    2. ``steps`` AdamW steps with ``--full-graph``'s settings on that
       batch: K2's launches as each step's requests ask, asserted every
       step (:func:`k2_as_asked`); the loss must fall;
    3. the restart: the same run with a failure injected at ``fail_at``
       and checkpoints every ``ckpt_every`` steps, held to the uninjected
       one by :func:`check_restart`; a second uninjected run gives the
       noise floor;
    4. the first step's loss and every gradient on the kernel path
       against the plain path on the same device, at ``parity_scale``;
    5. ``--sampled``: ``sampled_steps`` steps of ``sampled_seeds`` seeds
       through the query engine on the same triplet; K1's launches equal
       the engine's device batches.
    """
    from repro_torch.configs import get_arch
    from repro_torch.core import compbin as core_compbin
    from repro_torch.data.multihost import aggregate_stats, simulate_hosts
    from repro_torch.distributed import ResilientTrainer
    from repro_torch.launch import train as tr
    from repro_torch.models.gnn import gcn
    from repro_torch.optim import AdamWConfig, adamw_init

    on_gpu = torch.device(device).type == "cuda"
    spec = get_arch("gcn-cora")
    cfg = spec.make_reduced() if reduced else spec.make_config()
    out = {"arch": cfg.name, "d_in": cfg.d_in, "d_hidden": cfg.d_hidden,
           "n_classes": cfg.n_classes, "scale": scale,
           "edge_factor": edge_factor, "hosts": hosts}
    t_phase = time.perf_counter()

    # 1. the multi-host streamed load, K1's count read just after
    k1_0 = compbin_decode.launches
    host0 = core_compbin.host_decoded_bytes()
    t0 = time.perf_counter()
    fb = tr._gnn_full_graph_batches("gcn-cora", cfg, workdir, True, hosts,
                                    device=device, scale=scale,
                                    edge_factor=edge_factor)
    out["load_s"] = time.perf_counter() - t0
    out["k1_load_launches"] = k1_load = compbin_decode.launches - k1_0
    assert core_compbin.host_decoded_bytes() == host0, "host decode"
    results = fb.results
    agg = aggregate_stats(results)
    assert all(r.stats.decode_mode == "device" for r in results), \
        [r.stats.decode_reason for r in results]
    assert agg.host_decode_bytes == 0, agg.host_decode_bytes
    assert k1_load == (agg.partitions if on_gpu else 0), \
        (k1_load, agg.partitions)
    k1_0 = compbin_decode.launches
    single = simulate_hosts(fb.path, 1, device, open_kwargs=fb.open_kwargs,
                            feature_path=fb.feature_path,
                            label_path=fb.label_path)[0].stats
    out["k1_check_launches"] = compbin_decode.launches - k1_0
    books = {k: (getattr(agg, k), getattr(single, k))
             for k in STREAM_DATA_COUNTERS + ("partitions", "bytes_h2d")}
    for k in STREAM_DATA_COUNTERS:
        assert books[k][0] == books[k][1], (k, books[k])
    del single
    n_vertices = results[0].n_vertices
    assert agg.vertices == agg.feature_rows == agg.label_rows == n_vertices
    out.update(vertices=n_vertices, edges=agg.edges, align=fb.align,
               stats_hosts_vs_one=books,
               host_load_s=[r.stats.wall_s for r in results],
               host_ranges=[list(r.host_range) for r in results],
               host_partitions=[r.stats.partitions for r in results],
               bytes_h2d=agg.bytes_h2d,
               feature_bytes_h2d=agg.feature_bytes_h2d)
    batch = fb.batch
    assert batch["x"].shape == (n_vertices, cfg.d_in), batch["x"].shape
    assert batch["edge_src"].shape == (agg.edges,)
    assert batch["edge_src"].dtype == batch["edge_dst"].dtype == torch.int32
    assert batch["x"].device.type == torch.device(device).type

    # 2. full-graph AdamW steps, K2's counts read around every step
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps,
                          master_f32=True)
    init_fn, step = tr._make_step("gcn-cora", cfg, opt_cfg, "gnn",
                                  device=device)
    params0 = init_fn(seed)
    state0 = {"params": params0, "opt": adamw_init(params0, opt_cfg)}
    _cuda_sync(device)
    if on_gpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    state, losses, step_s, counts = _timed_steps(step, state0, batch, steps,
                                                 device)
    if on_gpu:        # one more step, under the profiler
        out["step_split"] = train_step_split(step, state, batch)
        counts.append(out["step_split"]["launches"])
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], f"full-graph loss did not fall: {losses}"
    add_k2(out, *counts)
    out.update(losses=losses, step_s=step_s,
               step_p50_s=statistics.median(step_s),
               k2_per_step=list(counts[0].values()),
               max_memory_allocated=(torch.cuda.max_memory_allocated(device)
                                     if on_gpu else None))

    # 3. the restart: the same run, a failure injected at `fail_at`; a
    # second uninjected run gives the noise floor of the atomic sums
    def run_trainer(ckpt_dir, inject):
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        inputs, seen = [], []

        def recording(st, b):
            inputs.append(st)
            return step(st, b)

        final = ResilientTrainer(
            recording, state0, ckpt_dir=ckpt_dir,
            ckpt_every=ckpt_every).run(
            itertools.repeat(batch), n_steps=steps, inject_failure_at=inject,
            on_metrics=lambda s, m: seen.append((s, float(m["loss"]))))
        return final, inputs, seen

    with k2_as_asked("[train] restart") as asked:
        restored, inputs, seen = run_trainer(
            os.path.join(workdir, "train_ckpt"), fail_at)
        replica = run_trainer(os.path.join(workdir, "train_ckpt_b"), None)[0]
    add_k2(out, asked.launches())
    resume = (fail_at // ckpt_every) * ckpt_every
    assert [s for s, _ in seen] == list(range(1, fail_at + 1)) + list(
        range(resume + 1, steps + 1)), seen
    out["restart"] = {"fail_at": fail_at, "ckpt_every": ckpt_every,
                      "steps_replayed": fail_at - resume,
                      **check_restart(inputs[fail_at], inputs[resume],
                                      [x for _, x in seen[fail_at:]],
                                      losses[resume:], restored, state,
                                      params0),
                      "noise_floor": param_drift(replica, state, params0)}
    del restored, state, state0, inputs, replica

    # 4. the first step's loss and grads, kernel path vs plain path
    pb = tr._gnn_full_graph_batches("gcn-cora", cfg, workdir, True, hosts,
                                    device=device, scale=parity_scale,
                                    edge_factor=edge_factor)
    out["k1_load_launches"] += sum(r.stats.partitions for r in pb.results) \
        if on_gpu else 0

    out["parity"] = {
        "scale": parity_scale, "vertices": pb.results[0].n_vertices,
        "edges": int(pb.batch["edge_src"].numel()),
        **first_step_parity(lambda p: gcn.loss_fn(p, pb.batch, cfg),
                            params0)}
    add_k2(out, out["parity"]["launches"])
    del pb
    if on_gpu:
        torch.cuda.empty_cache()

    # 5. --sampled: minibatches through the query engine, K1 zeroed just
    # before and read just after
    sopt = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=sampled_steps,
                       master_f32=True)
    sinit, sstep = tr._make_step("gcn-cora", cfg, sopt, "gnn", device=device)
    k1_0 = compbin_decode.launches
    sb = tr._gnn_sampled_batches("gcn-cora", cfg, workdir, True,
                                 batch_seeds=sampled_seeds, device=device,
                                 scale=scale, edge_factor=edge_factor)
    try:
        sp = sinit(seed)
        st = {"params": sp, "opt": adamw_init(sp, sopt)}
        fetch_s, sstep_s, slosses, scounts = [], [], [], []
        for _ in range(sampled_steps):
            t0 = time.perf_counter()
            b = next(sb)
            t1 = time.perf_counter()
            with k2_as_asked("[train] sampled step") as asked:
                st, met = sstep(st, b)
            slosses.append(float(met["loss"]))
            _cuda_sync(device)
            fetch_s.append(t1 - t0)
            sstep_s.append(time.perf_counter() - t1)
            scounts.append(asked.launches())
        k1_sampled = compbin_decode.launches - k1_0
        qs = sb.engine.stats.as_dict()
    finally:
        sb.close()
    assert np.isfinite(slosses).all(), slosses
    assert k1_sampled == (qs["device_batches"] if on_gpu else 0), \
        (k1_sampled, qs["device_batches"])
    assert not on_gpu or qs["device_batches"] > 0, qs
    out["sampled"] = {
        "steps": sampled_steps, "seeds": sampled_seeds,
        "losses": slosses, "fetch_p50_s": statistics.median(fetch_s),
        "step_p50_s": statistics.median(sstep_s),
        "total_p50_s": statistics.median(
            [a + c for a, c in zip(fetch_s, sstep_s)]),
        "k1_launches": k1_sampled, "device_batches": qs["device_batches"],
        "query_batches": qs["batches"], "edges": int(b["edge_dst"].numel()),
        "valid_edges": int((b["edge_dst"] >= 0).sum()),
        "nodes": int(b["x"].shape[0])}
    out["k1_launches"] = out["k1_load_launches"] + k1_sampled
    add_k2(out, *scounts)
    # the two training shapes K2's backward sees, for its timing
    out["full_graph_ids"] = batch["edge_dst"]
    out["sampled_ids"] = b["edge_dst"]
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# [gnn2]: PNA served and trained, MeshGraphNet and DimeNet trained, at
# full width; every segment sum on K2, every gradient of one on k2_grad
# ---------------------------------------------------------------------------

def gnn2_pna_train(device, workdir: str, cfg, *, scale: int, edge_factor: int,
                   hosts: int, steps: int, parity_scale: int,
                   seed: int = 0) -> dict:
    """PNA ``--full-graph`` on ``hosts`` simulated hosts over
    ``ensure_gnn_assets(scale, edge_factor)`` (d_in 64, 10 classes): the
    streamed load (K1 once a partition, nothing decoded on the host),
    ``steps`` AdamW steps with the CLI's settings (K2's launches asserted
    every step, the loss must fall), the peak, one more step under the
    profiler; then the first step at ``parity_scale`` against the plain
    path, its gradients held to the float64 plain path."""
    from repro_torch.core import compbin as core_compbin
    from repro_torch.data.multihost import aggregate_stats
    from repro_torch.launch import train as tr
    from repro_torch.models.gnn import pna
    from repro_torch.optim import AdamWConfig, adamw_init

    on_gpu = torch.device(device).type == "cuda"
    k1_0 = compbin_decode.launches
    host0 = core_compbin.host_decoded_bytes()
    t0 = time.perf_counter()
    fb = tr._gnn_full_graph_batches("pna", cfg, workdir, True, hosts,
                                    device=device, scale=scale,
                                    edge_factor=edge_factor)
    load_s = time.perf_counter() - t0
    agg = aggregate_stats(fb.results)
    k1 = compbin_decode.launches - k1_0
    assert core_compbin.host_decoded_bytes() == host0, "host decode"
    assert k1 == (agg.partitions if on_gpu else 0), (k1, agg.partitions)
    batch = fb.batch
    n = fb.results[0].n_vertices
    assert batch["x"].shape == (n, cfg.d_in) and \
        int(batch["labels"].max()) < cfg.n_classes

    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps,
                          master_f32=True)
    init_fn, step = tr._make_step("pna", cfg, opt_cfg, "gnn", device=device)
    params0 = init_fn(seed)
    state = {"params": params0, "opt": adamw_init(params0, opt_cfg)}
    if on_gpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    state, losses, secs, counts = _timed_steps(step, state, batch, steps,
                                               device)
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], f"PNA full-graph loss did not fall: " \
        f"{losses}"
    out = {"vertices": n, "edges": agg.edges, "hosts": hosts,
           "load_s": load_s, "losses": losses, "step_s": secs,
           "step_p50_s": statistics.median(secs),
           "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                    if on_gpu else None),
           "k1_launches": k1, "k2_per_step": list(counts[0].values())}
    if on_gpu:
        out["step_split"] = train_step_split(step, state, batch)
        counts.append(out["step_split"]["launches"])
    add_k2(out, *counts)
    out["full_graph_ids"] = batch["edge_dst"]
    del state, fb, batch
    if on_gpu:
        torch.cuda.empty_cache()

    k1_0 = compbin_decode.launches
    pb = tr._gnn_full_graph_batches("pna", cfg, workdir, True, hosts,
                                    device=device, scale=parity_scale,
                                    edge_factor=edge_factor)
    out["k1_launches"] += compbin_decode.launches - k1_0
    out["parity"] = {
        "graph": f"rmat({parity_scale}, {edge_factor})",
        "vertices": pb.results[0].n_vertices,
        "edges": int(pb.batch["edge_src"].numel()),
        **first_step_parity(lambda p: pna.loss_fn(p, pb.batch, cfg),
                            params0, exact=exact_plain_grads(
                                pna, cfg, pb.batch, params0))}
    add_k2(out, out["parity"]["launches"])
    return out


def gnn2_graph(arch: str, size: int):
    """``(name, CSR)`` of a full-batch step's graph: DimeNet's
    ``rmat(size, 16)``; MeshGraphNet's ``bipartite_mesh(size, size)``,
    the simulation mesh it models (in-degree <= 4).  On a power-law graph
    its 15 residual layers, with no normalization, sum hub neighborhoods
    past the f32 range: the full config's loss is inf on rmat(10, 16)
    (in-degree up to 342) in the JAX package as in the port."""
    from repro_torch.graph.generators import bipartite_mesh

    if arch == "meshgraphnet":
        return f"bipartite_mesh({size}, {size})", bipartite_mesh(size, size)
    return f"rmat({size}, 16)", rmat(size, 16, seed=1)


def gnn2_trained(arch: str, device, workdir: str, *, size: int,
                 parity_size: int, steps: int, reduced: bool = False,
                 seed: int = 0) -> dict:
    """MeshGraphNet or DimeNet at full width unless ``reduced``: the
    training CLI's run (``train.train``, the default mode: rmat(10, 8),
    64 seeds, fanouts (5, 5)) for ``steps`` steps, K2's launches as asked;
    then full-batch steps on ``full_graph_batch`` of
    :func:`gnn2_graph`'s graph at ``size``: three timed, one under the
    profiler; then the first step at ``parity_size`` held to the plain
    path, its gradients to the float64 plain path
    (:func:`first_step_parity`; the float64 run takes twice the f32
    one's memory)."""
    from repro_torch.launch import train as tr
    from repro_torch.launch.data_gnn import full_graph_batch
    from repro_torch.launch.steps import _GNN_MODULES
    from repro_torch.optim import AdamWConfig, adamw_init

    on_gpu = torch.device(device).type == "cuda"
    spec = get_arch(arch)
    cfg = spec.make_reduced() if reduced else spec.make_config()
    t0 = time.perf_counter()
    with k2_as_asked(f"[gnn2] {arch} CLI run") as asked:
        run = tr.train(arch, steps=steps, reduced=reduced, device=device,
                       workdir=os.path.join(workdir, "gnn2_train"),
                       ckpt_dir=os.path.join(workdir, f"gnn2_ckpt_{arch}"))
    cli_s = time.perf_counter() - t0
    assert len(run["losses"]) == steps and np.isfinite(run["losses"]).all(), \
        run["losses"]
    out = {"arch": cfg.name, "d_hidden": cfg.d_hidden,
           "n_bilinear": getattr(cfg, "n_bilinear", None),
           "n_targets": getattr(cfg, "n_targets", None),
           "cli_losses": run["losses"], "cli_wall_s": cli_s,
           "cli_step_p50_s": statistics.median(run["step_times_s"])}
    add_k2(out, asked.launches())
    del run

    graph, csr = gnn2_graph(arch, size)
    batch = full_graph_batch(arch, cfg, csr, np.random.default_rng(seed),
                             device=device)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps,
                          master_f32=True)
    init_fn, step = tr._make_step(arch, cfg, opt_cfg, "gnn", device=device)
    params0 = init_fn(seed)
    state = {"params": params0, "opt": adamw_init(params0, opt_cfg)}
    if on_gpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    state, losses, secs, counts = _timed_steps(step, state, batch, 3, device)
    assert np.isfinite(losses).all(), losses
    out.update(graph=graph, vertices=csr.n_vertices,
               k2_per_step=list(counts[0].values()),
               edges=int(batch["edge_src"].numel()),
               full_batch_losses=losses, step_s=secs,
               step_p50_s=statistics.median(secs[1:]),
               max_memory_allocated=(torch.cuda.max_memory_allocated(device)
                                     if on_gpu else None))
    if on_gpu:
        out["step_split"] = train_step_split(step, state, batch)
        counts.append(out["step_split"]["launches"])
    add_k2(out, *counts)
    ids = (batch["triplet_ji"], batch["graph_id"]) if arch == "dimenet" \
        else (batch["edge_dst"],)
    del state, batch
    if on_gpu:
        torch.cuda.empty_cache()
    mod = _GNN_MODULES[arch]
    pgraph, pcsr = gnn2_graph(arch, parity_size)
    pbatch = full_graph_batch(arch, cfg, pcsr, np.random.default_rng(seed),
                              device=device)
    out["parity"] = {
        "graph": pgraph, "vertices": pcsr.n_vertices,
        "edges": int(pbatch["edge_src"].numel()),
        **first_step_parity(lambda p: mod.loss_fn(p, pbatch, cfg), params0,
                            exact=exact_plain_grads(mod, cfg, pbatch,
                                                    params0))}
    add_k2(out, out["parity"]["launches"])
    if arch == "dimenet":
        out["triplet_ids"], out["graph_ids"] = ids
    else:
        (out["edge_ids"],) = ids
    return out


def phase_gnn2(device, workdir: str, *, scale: int = 18,
               edge_factor: int = 16, hosts: int = 2, steps: int = 10,
               parity_scale: int = 16, mgn_mesh: int = 450,
               mgn_parity_mesh: int = 256, dimenet_scale: int = 16,
               dimenet_parity_scale: int = 14, n_requests: int = 8,
               batch: int = 1024, reduced: bool = False,
               seed: int = 0) -> dict:
    """The JAX package's other three GNNs, full width unless ``reduced``
    (only the graphs are cut):

    1. PNA serving: :func:`phase_gnn` with ``arch="pna"`` on
       ``ensure_gnn_assets(scale, edge_factor)`` at d_in 64, 10 classes;
       logits within ``GNN_TOL`` of the plain CPU path;
    2. PNA training, :func:`gnn2_pna_train`;
    3. MeshGraphNet (full batch on a ``mgn_mesh`` x ``mgn_mesh`` mesh,
       parity on a ``mgn_parity_mesh`` one) and DimeNet (rmat(
       ``dimenet_scale``, 16), parity at ``dimenet_parity_scale``),
       :func:`gnn2_trained`.

    Returns each part's results, the main path's K1 / K2 / k2_grad
    launches, and the ids of the new K2 shapes for their timing."""
    t0 = time.perf_counter()
    spec = get_arch("pna")
    cfg = spec.make_reduced() if reduced else spec.make_config()
    serve = phase_gnn(device, workdir, scale=scale, edge_factor=edge_factor,
                      reduced=reduced, n_requests=n_requests, batch=batch,
                      seed=seed, arch="pna")
    pna_train = gnn2_pna_train(device, workdir, cfg, scale=scale,
                               edge_factor=edge_factor, hosts=hosts,
                               steps=steps, parity_scale=parity_scale,
                               seed=seed)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    mgn = gnn2_trained("meshgraphnet", device, workdir, size=mgn_mesh,
                       parity_size=mgn_parity_mesh, steps=steps,
                       reduced=reduced, seed=seed)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    dime = gnn2_trained("dimenet", device, workdir, size=dimenet_scale,
                        parity_size=dimenet_parity_scale, steps=steps,
                        reduced=reduced, seed=seed)
    parts = (pna_train, mgn, dime)
    return {
        "serve": serve, "pna_train": pna_train, "meshgraphnet": mgn,
        "dimenet": dime, "pna_cfg": {"d_in": cfg.d_in,
                                     "d_hidden": cfg.d_hidden,
                                     "n_classes": cfg.n_classes,
                                     "n_layers": cfg.n_layers},
        "k1_launches": serve["k1_launches"] + pna_train["k1_launches"],
        "k2_launches": serve["k2_launches"]
        + sum(p["k2_launches"] for p in parts),
        "k2_grad_launches": sum(p["k2_grad_launches"] for p in parts),
        "wall_s": time.perf_counter() - t0}


def gnn2_k2_shapes(g2: dict) -> dict:
    """The K2 shapes ``[gnn2]`` gives the kernel, by label: ``(ids, N, D,
    backward)`` with ``backward`` True where training gathers K2's
    gradient at that shape.  Takes the ids out of ``g2``."""
    srv, pt = g2["serve"], g2["pna_train"]
    mgn, dime = g2["meshgraphnet"], g2["dimenet"]
    d_pna = g2["pna_cfg"]["d_hidden"]
    dev = pt["full_graph_ids"].device
    return {
        "pna_served": (torch.from_numpy(srv.pop("edge_dst")).to(dev),
                       srv.pop("n_nodes"), d_pna, False),
        "pna_full_graph": (pt.pop("full_graph_ids"), pt["vertices"], d_pna,
                           True),
        "meshgraphnet": (mgn.pop("edge_ids"), mgn["vertices"],
                         mgn["d_hidden"], True),
        "dimenet_triplets": (dime.pop("triplet_ids"), dime["edges"],
                             dime["n_bilinear"], True),
        "dimenet_readout": (dime.pop("graph_ids"), 1, dime["n_targets"],
                            True)}


def check_k2_shapes(shapes: dict, seed: int = 6) -> dict:
    """K2 at each of ``shapes`` (:func:`gnn2_k2_shapes`): small-integer
    messages (every order of the adds gives the same f32 sums), so each
    design and the public path are held to the plain version bit for bit,
    and the backward (where the shape has one) too.  Returns the checks
    made by label."""
    rng = np.random.default_rng(seed)
    out = {}
    for label, (ids, n, d, backward) in shapes.items():
        msgs = _k2_messages(ids.numel(), d, True, rng, ids.device,
                            torch.float32)
        want = segment_sum_ref(msgs, ids, n)
        for design in K2_DESIGNS:
            got = _segment_sum_design(msgs, ids, n, design)
            assert torch.equal(got, want), \
                f"segment_sum {design} at {label} != plain version"
        assert torch.equal(segment_sum(msgs, ids, n), want), \
            f"segment_sum at {label} != plain version"
        checks = len(K2_DESIGNS) + 1
        del msgs, want
        if backward:
            grad = _k2_messages(n, d, True, rng, ids.device, torch.float32)
            assert torch.equal(segment_sum_backward(grad, ids, n),
                               segment_sum_grad_ref(grad, ids, n)), \
                f"segment_sum backward at {label} != plain version"
            checks += 1
        out[label] = {"e": ids.numel(), "n": n, "d": d, "checks": checks}
    return out


def log_gnn2(g2: dict) -> None:
    """The ``[gnn2]`` lines of :func:`phase_gnn2`'s results."""
    srv, pt = g2["serve"], g2["pna_train"]
    pc = g2["pna_cfg"]
    log(f"[gnn2] pna (d_in {pc['d_in']}, d_hidden {pc['d_hidden']}, "
        f"{pc['n_layers']} layers, {pc['n_classes']} classes) served on "
        f"rmat({srv['scale']}, {srv['edge_factor']}): {srv['requests']} "
        f"requests of {srv['batch']} seeds, {srv['nodes_per_request']} "
        f"nodes, {srv['edge_slots_per_request']} edge slots; p50 "
        f"{srv['p50_s'] * 1e3:.3f} ms, p99 {srv['p99_s'] * 1e3:.3f} ms, "
        f"first {srv['first_request_s'] * 1e3:.3f} ms; K1 launches "
        f"{srv['k1_launches']}, K2 {srv['k2_launches']}; logits within "
        f"{GNN_TOL} of the plain CPU path (max abs err "
        f"{srv['max_abs_err']:.3g}); assets {srv['assets_s']:.1f} s; "
        f"exclusive ms per request by tier: " + ", ".join(
            f"{t} {sec * 1e3:.3f}" for t, sec in
            sorted(srv["tier_s_per_request"].items())))
    par = pt["parity"]
    log(f"[gnn2] pna --full-graph on {pt['hosts']} simulated hosts "
        f"({pt['vertices']} vertices, {pt['edges']} edges, load "
        f"{pt['load_s']:.3f} s, K1 {pt['k1_launches']}): "
        f"{len(pt['losses'])} AdamW steps, loss {pt['losses'][0]:.6f} -> "
        f"{pt['losses'][-1]:.6f}; step p50 {pt['step_p50_s'] * 1e3:.3f} "
        f"ms (steps " + ", ".join(f"{t * 1e3:.1f}" for t in pt["step_s"])
        + f" ms); max_memory_allocated {pt['max_memory_allocated']} B; "
        f"K2 a step: {pt['k2_per_step'][0]} forward, "
        f"{pt['k2_per_step'][1]} backward (asserted every step)")
    for name, r in (("pna", pt), ("meshgraphnet", g2["meshgraphnet"]),
                    ("dimenet", g2["dimenet"])):
        par = r["parity"]
        log(f"[gnn2] {name} first step on {par['graph']} "
            f"({par['vertices']} vertices, {par['edges']} edges): loss "
            f"{par['loss']:.7g} vs plain {par['plain_loss']:.7g} (rel err "
            f"{par['loss_rel_err']:.3g} <= {TRAIN_LOSS_RTOL}); grads within "
            f"({EXACT_FACTOR} x {par['plain_relative_distance']:.3g} + "
            f"{TRAIN_GRAD_TOL[1]}) x max|g| of the float64 plain path, "
            f"{par['plain_relative_distance']:.3g} being the f32 plain "
            f"path's worst relative distance (max abs err kernel / plain: "
            + ", ".join(
                f"{k} {v:.3g} / {par['plain_max_abs_err_vs_f64'][k]:.3g}"
                for k, v in par["grad_max_abs_err_vs_f64"].items()) + ")")
    for r in (pt, g2["meshgraphnet"], g2["dimenet"]):
        sp = r.get("step_split") or {}
        log(f"[gnn2] {r.get('arch', 'pna')} one full-graph step "
            f"(torch.profiler): wall {sp.get('wall_ms', float('nan')):.3f}"
            f" ms; device " + (
                "not measured (no device time in the trace)"
                if not sp.get("device_ms") else ", ".join(
                    f"{k} {v:.3f} ms" for k, v in sp["device_ms"].items())
                + f"; idle share {sp['idle_share']:.3f}; top kernels "
                f"(ms, launches, name): " + "; ".join(
                    f"{ms:.3f} {n} {name}" for ms, n, name in
                    sp["top_kernels"])))
    for arch in ("meshgraphnet", "dimenet"):
        r = g2[arch]
        log(f"[gnn2] {r['arch']} (d_hidden {r['d_hidden']}): the CLI's "
            f"default mode, {len(r['cli_losses'])} steps of 64 seeds on "
            f"rmat(10, 8), loss {r['cli_losses'][0]:.6f} -> "
            f"{r['cli_losses'][-1]:.6f}, step p50 "
            f"{r['cli_step_p50_s'] * 1e3:.3f} ms; full batch on "
            f"{r['graph']} ({r['vertices']} vertices, "
            f"{r['edges']} edges): step p50 {r['step_p50_s'] * 1e3:.3f} ms "
            f"(steps " + ", ".join(f"{t * 1e3:.1f}" for t in r["step_s"])
            + f" ms), max_memory_allocated {r['max_memory_allocated']} B; "
            f"K2 a step {r['k2_per_step'][0]} forward, "
            f"{r['k2_per_step'][1]} backward (asserted every step)")


def log_k2_shape(label: str, r: dict) -> None:
    """The ``[kernel]`` lines of K2 (and its backward, where timed) at
    one of ``[gnn2]``'s shapes."""
    log(f"[kernel] segment_sum {label}: f32[{r['e']},{r['d']}] -> "
        f"f32[{r['n']},{r['d']}] ({r['valid_edges']} valid); plan "
        f"picks {r['design']}, fastest {r['fastest']}; " + "; ".join(
            f"{m} {v['ms']:.4f} ms" for m, v in r["designs"].items())
        + f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
        f"{r['gb_per_s']:.1f} GB/s; plain {r['plain_ms']:.4f} ms; "
        f"library_ms (index_add_) {r['library_ms']:.4f}; bit for bit "
        f"equal to the plain version (integer messages)")
    if "backward" in r:
        b = r["backward"]
        log(f"[kernel] segment_sum backward {label}: grad f32[{b['n']},"
            f"{b['d']}] gathered by int32[{b['e']}] "
            f"({b['valid_edges']} valid, {b['grad_rows_read']} "
            f"distinct rows): kernel {b['ms']:.4f} ms at VEC "
            f"{b['vec']}  bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']})  {b['gb_per_s']:.1f} GB/s  plain "
            f"{b['plain_ms']:.4f} ms  library_ms "
            f"{b['library_ms']:.4f} ({b['library_call']}); bit for "
            f"bit equal to the plain version")


# ---------------------------------------------------------------------------
# [moe]: the MoE LMs served, every attention call on K3 and every combine
# on K2; [lm_train]: LM training, dense and MoE
# ---------------------------------------------------------------------------

#: the MoE LMs served on the card and the layers each keeps (None: all;
#: dbrx-132b's 40 layers are ~263 GB in bf16, so 6 of them, ~42 GB)
MOE_SERVED = {"qwen2-moe-a2.7b": None, "dbrx-132b": 6}
#: K3 at the MoE LMs' served shapes (8 x 1024-token prompts, head dim
#: 128): qwen2-moe's 16 query over 16 KV heads, dbrx's 48 over 8
MOE_K3_SHAPES = {
    "qwen2_moe_prefill": dict(dtype=torch.bfloat16, b=8, s=1024, hq=16,
                              hkv=16, dh=128),
    "qwen2_moe_decode": dict(dtype=torch.bfloat16, b=8, live=1087, hq=16,
                             hkv=16, dh=128),
    "dbrx_prefill": dict(dtype=torch.bfloat16, b=8, s=1024, hq=48, hkv=8,
                         dh=128),
    "dbrx_decode": dict(dtype=torch.bfloat16, b=8, live=1087, hq=48, hkv=8,
                        dh=128),
}
#: the share of (token, layer) routings of the f32 check that may lie
#: closer to a tie than the two paths' measured router difference
#: (counted and reported; above it the check fails)
MOE_TIE_SHARE = 1e-3


@contextlib.contextmanager
def recorded_moe(calls: list, keep_messages: bool = True):
    """Every ``moe_ffn`` call of the port's transformer appends a record
    and then runs as it would: its router probabilities and top-k
    (:func:`route` on its input), the capacity, the kept mask
    (:func:`sort_assignments`), the token count, and -- with
    ``keep_messages`` -- the scatter arm's combine inputs (``messages,
    ids, T``) as its segment sum received them (else the ids only)."""
    from repro_torch.models import transformer as tf

    real_moe, real_ss = tf.moe_ffn, tf.segment_sum

    def moe_ffn(x, lp, cfg, *, no_drop=False, eval_mode=False):
        probs, _, idx = tf.route(x, lp["router"], cfg)
        cap = tf.moe_capacity(cfg, x.shape[0], no_drop=no_drop,
                              eval_mode=eval_mode)
        rec = {"probs": probs.detach(), "idx": idx, "capacity": cap,
               "keep": tf.sort_assignments(idx, cfg.e_pad, cap)[4],
               "tokens": x.shape[0]}

        def segment_sum_seen(m, ids, n):
            rec["combine"] = ((m.detach() if keep_messages else None), ids,
                              n)
            return real_ss(m, ids, n)

        tf.segment_sum = segment_sum_seen
        try:
            out = real_moe(x, lp, cfg, no_drop=no_drop, eval_mode=eval_mode)
        finally:
            tf.segment_sum = real_ss
        calls.append(rec)
        return out

    tf.moe_ffn = moe_ffn
    try:
        yield
    finally:
        tf.moe_ffn = real_moe


def top_k_margins(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Per token, its K-th largest router probability minus its
    (K+1)-th (inf with only K experts)."""
    top = torch.topk(probs, min(k + 1, probs.shape[-1]), dim=-1).values
    if top.shape[-1] == k:
        return torch.full(probs.shape[:-1], float("inf"),
                          device=probs.device)
    return top[..., k - 1] - top[..., k]


def _kept_pairs(rec: dict, n_slots: int) -> torch.Tensor:
    """[T, n_slots] bool: which (token, expert) assignments were kept."""
    from repro_torch.models import transformer as tf

    _, e_sorted, t_sorted, _, keep = tf.sort_assignments(
        rec["idx"], n_slots, rec["capacity"])
    out = torch.zeros(rec["tokens"], n_slots, dtype=torch.bool,
                      device=keep.device)
    out[t_sorted[keep], e_sorted[keep]] = True
    return out


def check_moe_routing(got: list, want: list, k: int, n_slots: int,
                      batch: int) -> dict:
    """Two runs' MoE routing held together call by call (``want`` the
    plain path's, :func:`recorded_moe`'s records).  A token whose plain
    path's top-k margin exceeds twice the two runs' largest difference in
    its router probabilities cannot route otherwise: its experts must be
    equal as integers.  The tokens below that margin are counted
    (``near_ties``; at most ``MOE_TIE_SHARE`` of the routings), and those
    of them routed to other experts (``flips``) mark their experts and
    their batch rows: on every other expert the kept (token, expert)
    assignments must be equal as integers.  Returns the counts, the
    smallest margin and largest difference seen, and the batch rows a
    flip touched (their logits cannot be compared)."""
    assert len(got) == len(want), (len(got), len(want))
    near = flips = routings = 0
    low, diff_max, rows = float("inf"), 0.0, set()
    for a, b in zip(got, want):
        assert a["tokens"] == b["tokens"] and a["capacity"] == b["capacity"]
        diff = (a["probs"].double() - b["probs"].double()).abs().amax(-1)
        margin = top_k_margins(b["probs"].double(), k)
        flipped = (a["idx"].sort(-1).values
                   != b["idx"].sort(-1).values).any(-1)
        clear = margin > 2 * diff
        bad = clear & flipped
        assert not bool(bad.any()), (
            f"a token routed to other experts with a margin "
            f"{float(margin[bad].min()):.3g} above twice its router "
            f"difference {float(diff[bad].max()):.3g}")
        near += int((~clear).sum())
        routings += a["tokens"]
        low = min(low, float(margin.min()))
        diff_max = max(diff_max, float(diff.max()))
        touched = torch.zeros(n_slots, dtype=torch.bool,
                              device=a["idx"].device)
        touched[a["idx"][flipped].reshape(-1)] = True
        touched[b["idx"][flipped].reshape(-1)] = True
        flips += int(flipped.sum())
        per_row = a["tokens"] // batch
        rows |= {int(t) // per_row
                 for t in torch.nonzero(flipped).reshape(-1).tolist()}
        ka, kb = _kept_pairs(a, n_slots), _kept_pairs(b, n_slots)
        assert torch.equal(ka[:, ~touched], kb[:, ~touched]), \
            "kept assignments differ on an expert no flip touched"
    assert near <= MOE_TIE_SHARE * routings, \
        f"{near} of {routings} routings closer to a tie than the paths' " \
        f"difference"
    return {"routings": routings, "near_ties": near, "flips": flips,
            "min_margin": low, "max_router_diff": diff_max,
            "rows_flipped": sorted(rows)}


def check_moe_combine(calls: list, label: str) -> float:
    """K2 on the MoE combine's recorded inputs (the first prefill and
    the first decode call of a kernel-path run) against its plain
    version, within ``K2_TOL``; returns the worst max abs error."""
    worst = 0.0
    firsts = [c for c in calls if "combine" in c]
    picked = [firsts[0]] + [c for c in firsts if c["tokens"]
                            != firsts[0]["tokens"]][:1]
    for c in picked:
        msgs, ids, n = c["combine"]
        worst = max(worst, _k2_close(segment_sum(msgs, ids, n),
                                     segment_sum_ref(msgs, ids, n),
                                     torch.float32,
                                     f"{label} combine (T={n})"))
    return worst


def moe_check(device, cfg, *, batch: int, prompt_len: int, n_tokens: int,
              seed: int = 0) -> dict:
    """The MoE model ``cfg`` (f32, its first layers) served through
    ``serve_lm`` on the kernel path (K3 on every attention call, K2 on
    every combine) and on the plain path (:func:`plain_attention`,
    :func:`plain_segment_sum`) on the same weights and prompts: K3's and
    K2's launches (one a layer a step on the kernel path, none on the
    plain path); the routing held together (:func:`check_moe_routing`);
    every step's last-position logits within ``LM_TOL`` and the greedy
    tokens equal (:func:`_compare_logits`) on every batch row no flip
    touched; K2 on the recorded combines against its plain version
    (:func:`check_moe_combine`)."""
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer as tf

    on_gpu = torch.device(device).type == "cuda"
    params = tf.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(seed))
    kw = dict(batch=batch, prompt_len=prompt_len, n_tokens=n_tokens,
              device=device, params=params, keep_logits=True)
    got_calls, want_calls = [], []
    k3, k2 = flash_attention.launches, segment_sum.launches
    with recorded_moe(got_calls):
        got_tok, got = serve_lm(cfg, **kw)
    launches = (flash_attention.launches - k3, segment_sum.launches - k2)
    want_per = cfg.n_layers * n_tokens if on_gpu else 0
    assert launches == (want_per, want_per), (launches, want_per)
    k3, k2 = flash_attention.launches, segment_sum.launches
    with plain_attention(), plain_segment_sum(), recorded_moe(want_calls):
        want_tok, want = serve_lm(cfg, **kw)
    assert (flash_attention.launches, segment_sum.launches) == (k3, k2)
    routing = check_moe_routing(got_calls, want_calls, cfg.top_k, cfg.e_pad,
                                batch)
    rows = [r for r in range(batch) if r not in routing["rows_flipped"]]
    assert rows, "every batch row holds a routing flip"
    e2e = _compare_logits(got_tok[rows], got["logits"][:, rows],
                          want_tok[rows], want["logits"][:, rows],
                          tol=LM_TOL)
    err = check_moe_combine(got_calls, cfg.name)
    del params
    return {"arch": cfg.name, "layers": cfg.n_layers, "batch": batch,
            "prompt_len": prompt_len, "n_tokens": n_tokens,
            "k3_launches": launches[0], "k2_launches": launches[1],
            "routing": routing, "logits_max_abs_err": e2e["max_abs_err"],
            "rows_compared": len(rows), "token_flips": e2e["flips"],
            "combine_max_abs_err": err}


def moe_served(device, cfg, *, batch: int, prompt_len: int, n_tokens: int,
               seed: int = 0) -> dict:
    """The MoE model ``cfg`` served in its own dtype through ``serve_lm``
    on random weights: a 2-token warm-up (which also records the combine
    ids of the first layer's prefill and decode step, for K2's timings),
    then the timed run with K3's and K2's counts zeroed just before and
    read just after (one launch each a layer a step), the tokens checked
    for range and the logits for finiteness; peak memory; then one
    prefill and 3 decode steps under the profiler (K3, K2, GEMMs,
    copies, other)."""
    from repro_torch.configs.shapes import LMShape
    from repro_torch.launch.model_flops import lm_model_flops
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer as tf

    on_gpu = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=device)
                            .manual_seed(seed))
    _cuda_sync(device)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    kw = dict(batch=batch, prompt_len=prompt_len, device=device,
              params=params)
    calls = []
    with recorded_moe(calls, keep_messages=False):
        serve_lm(cfg, n_tokens=2, **kw)                 # warm-up
    ids = {"prefill": calls[0]["combine"][1:],
           "decode": calls[cfg.n_layers]["combine"][1:]}
    del calls
    if on_gpu:
        torch.cuda.reset_peak_memory_stats(device)
    flash_attention.launches = segment_sum.launches = 0
    tokens, t = serve_lm(cfg, n_tokens=n_tokens, keep_logits=True, **kw)
    launches = (flash_attention.launches, segment_sum.launches)
    want = cfg.n_layers * n_tokens if on_gpu else 0
    assert launches == (want, want), (launches, want)
    logits = t.pop("logits")
    assert tokens.shape == (batch, n_tokens)
    assert tokens.min() >= 0 and tokens.max() < cfg.vocab
    assert np.isfinite(logits).all(), "non-finite logits"
    assert np.array_equal(tokens, logits.argmax(-1).T)
    flops = lm_model_flops(cfg, LMShape("served", prompt_len, batch,
                                        "prefill"))
    steps = max(1, n_tokens - 1)
    out = {"arch": cfg.name, "dtype": str(cfg.dtype), "layers": cfg.n_layers,
           "d_model": cfg.d_model, "experts": cfg.n_experts,
           "slots": cfg.e_pad, "top_k": cfg.top_k, "params": n_params,
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(params)),
           "init_s": init_s, "batch": batch, "prompt_len": prompt_len,
           "n_tokens": n_tokens, "prefill_ms": t["prefill_s"] * 1e3,
           "decode_ms_per_step": t["decode_s"] / steps * 1e3,
           "tokens_per_s": t["tokens_per_s"], "prefill_flops": flops,
           "prefill_flops_per_s": flops / t["prefill_s"],
           "prefill_capacity": tf.moe_capacity(cfg, batch * prompt_len,
                                               eval_mode=True),
           "decode_capacity": tf.moe_capacity(cfg, batch, no_drop=True,
                                              eval_mode=True),
           "k3_launches": launches[0], "k2_launches": launches[1],
           "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                    if on_gpu else None),
           "combine_ids": ids}
    if on_gpu:
        out["device_split"] = lm_device_split(
            cfg, params, batch, prompt_len, 3, _train_kernel_class,
            ("k3", "k2", "gemm", "copy", "other"))
    del params
    return out


def phase_moe(device, *, batch: int = 8, prompt_len: int = 1024,
              n_tokens: int = 64, check_layers: int = 2,
              check_batch: int = 2, check_prompt_len: int = 256,
              check_tokens: int = 4, served=None, reduced: bool = False,
              seed: int = 0) -> dict:
    """``[moe]``: qwen2-moe-a2.7b at full width and depth and dbrx-132b
    at full width on 6 of its 40 layers (``MOE_SERVED``; ``served`` maps
    an arch to other depths), each: :func:`moe_check` at its first
    ``check_layers`` layers in f32, then :func:`moe_served` in bf16 (the
    reduced configs in f32 with ``reduced``).  Each model is freed before
    the next step."""
    t_phase = time.perf_counter()
    out = {}
    for arch, layers in (served or MOE_SERVED).items():
        spec = get_arch(arch)
        cfg = spec.make_reduced() if reduced else spec.make_config()
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        t0 = time.perf_counter()
        check = moe_check(device, dataclasses.replace(
            cfg, n_layers=min(check_layers, cfg.n_layers),
            dtype=torch.float32), batch=check_batch,
            prompt_len=check_prompt_len, n_tokens=check_tokens, seed=seed)
        check["wall_s"] = time.perf_counter() - t0
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        r = moe_served(device, cfg, batch=batch, prompt_len=prompt_len,
                       n_tokens=n_tokens, seed=seed)
        r["wall_s"] = time.perf_counter() - t0
        r["check"] = check
        out[arch] = r
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return {"models": out, "k3_launches": sum(
        r["k3_launches"] for r in out.values()),
        "k2_launches": sum(r["k2_launches"] for r in out.values()),
        "wall_s": time.perf_counter() - t_phase}


#: ``[lm_train]``'s models: (arch, layers kept (None: all), batch,
#: sequence, checkpoint every, failure at).  Batch and sequence keep the
#: activations small (the plain attention keeps its score tiles for the
#: backward); qwen2-moe's 1.83 B parameters at 2 layers set its peak:
#: AdamW with f32 masters holds 14 bytes a parameter (25.6 GB), and two
#: states live during the functional update.  The restarts write 3 and 2
#: checkpoints (15.2 and 51.3 GB): they go to ``LM_CKPT_ROOT``
LM_TRAIN = (("smollm-360m", None, 8, 512, 4, 5),
            ("qwen2-moe-a2.7b", 2, 4, 512, 5, 6))
#: where ``[lm_train]``'s restarts checkpoint on the card's machine: a
#: RAM file system.  The machine ends a command that writes more than
#: 45 GiB to its disk, deleted files included, and the two LMs'
#: checkpoints alone are 66.5 GB.  Each restart's checkpoint is removed
#: once the trainer has resumed from it, so the RAM holds one at a time
LM_CKPT_ROOT = "/dev/shm"
#: the first step's parity run: batch x sequence
LM_PARITY = (2, 128)
#: AdamW's warmup steps in ``[lm_train]`` (lr 1e-3 after them, cosine to
#: the last step): the CLI's 10 would leave 10 steps too little movement
#: to show the loss fall
LM_TRAIN_WARMUP = 2


def write_zipf_shard(path: str, vocab: int, n: int = 200_000,
                     seed: int = 0) -> None:
    """A token shard of ``n`` ids drawn from a Zipf(1.3) law over the
    vocabulary, as text's unigram law: on the training CLI's own uniform
    draw the loss of a tied-embedding model starts at ln V and cannot
    fall, so the check that it falls needs a stream with something to
    learn."""
    from repro_torch.data import write_token_shard

    rng = np.random.default_rng(seed)
    write_token_shard(path, (rng.zipf(1.3, n) - 1) % vocab, vocab)


def dir_bytes(path: str) -> int:
    """The bytes of every file under ``path``."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def state_fingerprint(tree, chunk: int = 1 << 26) -> dict:
    """Per leaf (:func:`flat_tree`'s paths), one float64 0-d tensor: the
    leaf's bit patterns (as integers of its own width) dotted with fixed
    pseudo-random float64 weights, on the leaf's device, a chunk at a
    time.  Two leaves that differ in any bit differ here but with
    vanishing chance, so a restored state is held to the saved one bit
    for bit without a second copy of either (``torch.equal`` on the
    fingerprints)."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out, weights = {}, {}
    for path, leaf in flat_tree(tree).items():
        bits = leaf.detach().reshape(-1).view(ints[leaf.element_size()])
        dev = str(bits.device)
        if dev not in weights:
            gen = torch.Generator(device=bits.device).manual_seed(12345)
            weights[dev] = torch.rand(chunk, generator=gen,
                                      dtype=torch.float64, device=bits.device)
        w = weights[dev]
        total = torch.zeros((), dtype=torch.float64, device=bits.device)
        for i in range(0, bits.numel(), chunk):
            part = bits[i:i + chunk]
            total += (part.double() * w[:part.numel()]).sum()
        out[path] = total
    return out


def lm_train_one(arch: str, device, workdir: str, *, layers, batch: int,
                 seq: int, ckpt_every: int, fail_at: int, steps: int = 10,
                 reduced: bool = False, seed: int = 0,
                 ckpt_root: str | None = None) -> dict:
    """One LM trained through the training CLI's pieces
    (``launch/train.py``: ``_lm_batches`` over a token shard through
    PG-Fuse, decoded on the host; ``_make_step``: the training route's
    plain attention, K2 on the MoE combine and its backward kernel on
    the combine's gradient; AdamW with f32 masters):

    1. ``steps`` timed steps on the first ``steps`` batches (a
       :func:`write_zipf_shard` stream), K2's launches a step as asked
       (:func:`k2_as_asked`: one a layer for the MoE, none for a dense
       FFN), finite losses that fall (the last three's mean below the
       first three's); one more step under the profiler;
    2. the restart: the same steps through ``ResilientTrainer`` with a
       failure injected at ``fail_at`` and checkpoints every
       ``ckpt_every`` steps (one kept) under ``ckpt_root`` (default: the
       model's work directory), the batches replayed from the restored
       step (the trainer checkpoints no data position), held to step 1's
       run by :func:`check_restart` (the saved and resumed states by
       :func:`state_fingerprint`); the checkpoint resumed from is removed
       once the next step is done, and the bytes written are recorded;
    3. the first step in f32 at ``LM_PARITY`` on the kernel path against
       the plain path (:func:`first_step_parity`; the MoE's gradients
       held to the plain path in float64 throughout, its combine
       :func:`segment_sum_f64`), with each run's routing held to the
       plain path's (:func:`check_moe_routing`: no token may route to
       other experts, or its gradients could not be compared)."""
    from repro_torch.distributed.fault_tolerance import ResilientTrainer
    from repro_torch.launch import train as tr
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, adamw_init

    t_start = time.perf_counter()
    on_gpu = torch.device(device).type == "cuda"
    spec = get_arch(arch)
    cfg = spec.make_reduced() if reduced else spec.make_config()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    wd = os.path.join(workdir, f"lm_train_{arch}")
    os.makedirs(wd, exist_ok=True)
    write_zipf_shard(os.path.join(wd, "tokens.ctok"), cfg.vocab, seed=seed)
    t0 = time.perf_counter()
    source = tr._lm_batches(cfg, batch, seq, wd, True, device=device)
    try:
        batches = [next(source) for _ in range(steps + 1)]
    finally:
        source.close()
    load_s = time.perf_counter() - t0
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=LM_TRAIN_WARMUP,
                          total_steps=steps, master_f32=True)
    init_fn, step = tr._make_step(arch, cfg, opt_cfg, "lm", device=device)
    if on_gpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    allocated_before = torch.cuda.memory_allocated(device) if on_gpu else None
    log(f"[lm_train] {arch}: {allocated_before} B allocated on the card "
        f"before its run")

    # 1. the timed steps.  The initial state is drawn anew (the same
    # seed, the same bits) wherever it is needed rather than kept: AdamW's
    # state is 14 bytes a parameter, ~26 GB for qwen2-moe at 2 layers,
    # and two of it live during an update
    state = {"params": init_fn(seed)}
    state["opt"] = adamw_init(state["params"], opt_cfg)
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    losses, secs, counts = [], [], []
    for b in batches[:steps]:
        state, l1, s1, c1 = _timed_steps(step, state, b, 1, device)
        losses += l1
        secs += s1
        counts += c1
    assert np.isfinite(losses).all() and \
        np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "dtype": str(cfg.dtype), "batch": batch, "seq": seq,
           "params": n_params,
           "state_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(state)),
           "load_s": load_s, "losses": losses, "step_s": secs,
           "step_p50_s": statistics.median(secs[1:]),
           "k2_per_step": list(counts[0].values()),
           "memory_allocated_before": allocated_before,
           "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                    if on_gpu else None)}
    if on_gpu:
        out["step_split"] = train_step_split(step, state, batches[steps])
        counts.append(out["step_split"]["launches"])
    if cfg.moe:
        # the combine's ids at this shape, for K2's backward timing
        calls = []
        with k2_as_asked(f"[lm_train] {arch} combine ids") as asked, \
                torch.no_grad(), recorded_moe(calls, keep_messages=False):
            tf.forward_hidden(state["params"], batches[0]["tokens"], cfg)
        counts.append(asked.launches())
        out["combine_ids"] = calls[0]["combine"][1:]
        del calls
    # the uninjected run's params wait on the host while the restart runs
    clean = {"params": tree_map(lambda t: t.to("cpu"), state["params"])}
    del state
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()

    # 2. the restart, on the same batches replayed; the state the trainer
    # checkpointed and the one it resumed from are held by their
    # fingerprints (:func:`state_fingerprint`), not kept
    t_restart = time.perf_counter()
    resume = (fail_at // ckpt_every) * ckpt_every
    ckpt_dir = os.path.join(ckpt_root or wd, f"ckpt_{arch}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    inputs, seen, ckpt_bytes = {}, [], []

    def recording(st, b):
        n = recording.calls
        recording.calls += 1
        if n in (resume, fail_at):
            inputs[n] = state_fingerprint(st)
        return step(st, b)

    def on_metrics(s, m):
        seen.append((s, float(m["loss"])))
        if len(seen) == fail_at + 1:        # the first step after the restore
            done = os.path.join(ckpt_dir, f"step_{resume:08d}")
            ckpt_bytes.append(dir_bytes(done))
            shutil.rmtree(done)

    recording.calls = 0
    replay = batches[:fail_at + 1] + batches[resume:steps]
    first = {"params": init_fn(seed)}
    first["opt"] = adamw_init(first["params"], opt_cfg)
    start = tree_map(lambda t: t.to("cpu"), first["params"])
    trainer = ResilientTrainer(recording, first, ckpt_dir=ckpt_dir,
                               ckpt_every=ckpt_every, keep_last=1)
    del first
    with k2_as_asked(f"[lm_train] {arch} restart") as asked:
        restored = trainer.run(iter(replay), n_steps=steps,
                               inject_failure_at=fail_at,
                               on_metrics=on_metrics)
    counts.append(asked.launches())
    ckpt_bytes.append(dir_bytes(ckpt_dir))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    assert [s for s, _ in seen] == list(range(1, fail_at + 1)) + list(
        range(resume + 1, steps + 1)), seen
    # the trainer saves after every ckpt_every-th step and the last one
    saves = sum(s % ckpt_every == 0 or s == steps for s, _ in seen)
    assert min(ckpt_bytes) > 0, ckpt_bytes
    restored = {"params": restored["params"]}
    del trainer
    gc.collect()
    clean = {"params": tree_map(lambda t: t.to(device), clean["params"])}
    out["restart"] = {"fail_at": fail_at, "ckpt_every": ckpt_every,
                      "steps_replayed": fail_at - resume,
                      "ckpt_root": ckpt_root or wd, "checkpoints": saves,
                      "checkpoint_bytes": ckpt_bytes[0],
                      # the manifests differ by their step numbers only
                      "bytes_written": saves * ckpt_bytes[0],
                      **check_restart(inputs[fail_at], inputs[resume],
                                      [x for _, x in seen[fail_at:]],
                                      losses[resume:], restored, clean,
                                      tree_map(lambda t: t.to(device),
                                               start))}
    del restored, clean, inputs, batches, start
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()
    out["restart"]["wall_s"] = time.perf_counter() - t_restart
    add_k2(out, *counts)
    return _lm_parity(out, cfg, init_fn, device, seed, t_start)


def _lm_parity(out: dict, cfg, init_fn, device, seed: int,
               t_start: float) -> dict:
    """:func:`lm_train_one`'s last part: the first step, f32, the kernel
    path against the plain path (and float64 for an MoE), its K2
    launches added to ``out``'s totals."""
    from repro_torch.models import transformer as tf

    t_parity = time.perf_counter()

    # 3. the first step, f32, kernel path vs plain path (and float64)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = tree_map(torch.Tensor.float, init_fn(seed))
    pb, ps = LM_PARITY
    toks = torch.as_tensor(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (pb, ps + 1)), device=device)
    runs = []

    def routed(loss_fn):
        def run(p):
            runs.append([])
            with recorded_moe(runs[-1], keep_messages=False):
                return loss_fn(p)
        return run

    def loss_fn(p, c=cfg32):
        return tf.loss_fn(p, toks[:, :-1], toks[:, 1:], c)

    def exact() -> dict:
        cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
        with plain_segment_sum(segment_sum_f64):
            return loss_and_grads(routed(lambda p: loss_fn(p, cfg64)),
                                  tree_map(torch.Tensor.double, params32))[1]

    par = first_step_parity(routed(loss_fn), params32,
                            exact=exact if cfg.moe else None)
    if cfg.moe:
        par["routing"] = {
            "kernel_vs_plain": check_moe_routing(runs[0], runs[1],
                                                 cfg.top_k, cfg.e_pad, pb),
            "float64_vs_plain": check_moe_routing(runs[2], runs[1],
                                                  cfg.top_k, cfg.e_pad, pb)}
        for name, r in par["routing"].items():
            assert r["flips"] == 0, (
                f"{name}: {r['flips']} token(s) routed to other experts at a "
                f"near tie (smallest margin {r['min_margin']:.3g}): the "
                f"gradients cannot be compared")
    out["parity"] = {"batch": pb, "seq": ps, **par,
                     "wall_s": time.perf_counter() - t_parity}
    add_k2(out, par["launches"])
    out["wall_s"] = time.perf_counter() - t_start
    return out


def phase_lm_train(device, workdir: str, *, models=LM_TRAIN, steps: int = 10,
                   reduced: bool = False, seed: int = 0,
                   ckpt_root: str | None = None) -> dict:
    """``[lm_train]``: each of ``models`` (``LM_TRAIN``: smollm-360m at
    full width and depth, qwen2-moe-a2.7b at full width on 2 layers, its
    MoE combine on K2 at D 2048) trained by :func:`lm_train_one`, its
    restart checkpointing under ``ckpt_root``, freed before the next."""
    out = {}
    for arch, layers, batch, seq, ckpt_every, fail_at in models:
        out[arch] = lm_train_one(arch, device, workdir, layers=layers,
                                 batch=batch, seq=seq, ckpt_every=ckpt_every,
                                 fail_at=fail_at, steps=steps,
                                 reduced=reduced, seed=seed,
                                 ckpt_root=ckpt_root)
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return {"models": out,
            "k2_launches": sum(r["k2_launches"] for r in out.values()),
            "k2_grad_launches": sum(r["k2_grad_launches"]
                                    for r in out.values())}


def moe_k2_shapes(moe: dict, lmt: dict) -> dict:
    """K2's shapes on this slice's path, ``label -> (ids, n, d,
    backward)``: the combine of each served MoE model's prefill and
    decode step (recorded in :func:`moe_served`'s warm-up) and of the
    MoE training step (its backward too)."""
    out = {}
    for arch, r in moe["models"].items():
        name = arch.split("-")[0].replace("qwen2", "qwen2_moe")
        for part, (ids, n) in r["combine_ids"].items():
            out[f"{name}_combine_{part}"] = (ids, n, r["d_model"], False)
    for arch, r in lmt["models"].items():
        if "combine_ids" in r:
            ids, n = r["combine_ids"]
            out[f"{arch.split('-')[0]}_moe_combine_train"] = (
                ids, n, r["d_model"], True)
    return out


def log_moe(moe: dict) -> None:
    """The ``[moe]`` lines: per model the f32 check, the served run and
    the profiled split."""
    for arch, r in moe["models"].items():
        c, rt = r["check"], r["check"]["routing"]
        log(f"[moe] {arch} f32 check at {c['layers']} layers, {c['batch']} "
            f"x {c['prompt_len']}-token prompts, {c['n_tokens']} tokens: K3 "
            f"{c['k3_launches']} and K2 {c['k2_launches']} launches on the "
            f"kernel path, none on the plain path; routing: "
            f"{rt['routings']} token routings, {rt['near_ties']} below the "
            f"measured router difference (largest {rt['max_router_diff']:.3g}"
            f", smallest top-k margin {rt['min_margin']:.3g}), "
            f"{rt['flips']} routed otherwise, every other routing and kept "
            f"assignment equal as integers; last-position logits within "
            f"{LM_TOL} of the plain path on {c['rows_compared']} of "
            f"{c['batch']} rows (max abs err {c['logits_max_abs_err']:.3g}), "
            f"{len(c['token_flips'])} greedy-token flips; K2 on the "
            f"recorded combines within {K2_TOL[torch.float32]} of its plain "
            f"version (max abs err {c['combine_max_abs_err']:.3g}); "
            f"{c['wall_s']:.1f} s")
        log(f"[moe] {arch} {r['dtype'].split('.')[-1]} at {r['layers']} "
            f"layers (d_model {r['d_model']}, {r['experts']} experts in "
            f"{r['slots']} slots, top-{r['top_k']}; {r['params']} parameter "
            f"elements, {r['param_bytes']} B, drawn in {r['init_s']:.1f} s): "
            f"{r['batch']} x {r['prompt_len']}-token prompts, "
            f"{r['n_tokens']} tokens: prefill {r['prefill_ms']:.3f} ms "
            f"(capacity {r['prefill_capacity']}; {r['prefill_flops']:.4g} "
            f"FLOP by lm_model_flops, "
            f"{r['prefill_flops_per_s'] / 1e12:.2f} TFLOP/s), decode "
            f"{r['decode_ms_per_step']:.3f} ms per step (capacity "
            f"{r['decode_capacity']}, no drop), {r['tokens_per_s']:.1f} "
            f"tokens/s; K3 launches {r['k3_launches']}, K2 launches "
            f"{r['k2_launches']} ({r['layers']} a step); "
            f"max_memory_allocated {r['max_memory_allocated']} B; "
            f"{r['wall_s']:.1f} s")
        for part, sp in (r.get("device_split") or {}).items():
            dev = sp["device_ms"]
            log(f"[moe] {arch} {part} (torch.profiler, per "
                f"{'prefill' if part == 'prefill' else 'decode step'}): wall "
                f"{sp['wall_ms']:.3f} ms; device "
                + ("not measured (no device time in the trace)" if dev is None
                   else ", ".join(f"{k} {v:.3f} ms" for k, v in dev.items())
                   + f"; idle share {sp['idle_share']:.3f}"))
            log(f"[moe] {arch} {part} top kernels (ms, launches, name): "
                + "; ".join(f"{ms:.3f} {n} {name}"
                            for ms, n, name in sp["top_kernels"]))


def log_lm_train(lmt: dict) -> None:
    """The ``[lm_train]`` lines: per model the steps, the profiled split,
    the restart and the first step's parity."""
    for arch, r in lmt["models"].items():
        log(f"[lm_train] {arch} ({r['dtype'].split('.')[-1]}, "
            f"{r['layers']} layers, d_model {r['d_model']}, {r['params']} "
            f"parameters, AdamW state {r['state_bytes']} B with f32 "
            f"masters), {r['batch']} x "
            f"{r['seq']} tokens a step (Zipf shard through PG-Fuse, "
            f"decoded on the host, {r['load_s']:.2f} s): "
            f"{len(r['losses'])} steps, loss {r['losses'][0]:.5f} -> "
            f"{r['losses'][-1]:.5f}; step p50 {r['step_p50_s'] * 1e3:.3f} ms "
            f"(steps " + ", ".join(f"{t * 1e3:.1f}" for t in r["step_s"])
            + f" ms); max_memory_allocated {r['max_memory_allocated']} B "
            f"({r['memory_allocated_before']} B before); "
            f"K2 a step: {r['k2_per_step'][0]} forward, "
            f"{r['k2_per_step'][1]} backward (asserted every step); "
            f"{r['wall_s']:.1f} s")
        sp = r.get("step_split") or {}
        log(f"[lm_train] {arch} one step (torch.profiler): wall "
            f"{sp.get('wall_ms', float('nan')):.3f} ms; device "
            + ("not measured (no device time in the trace)"
               if not sp.get("device_ms") else ", ".join(
                   f"{k} {v:.3f} ms" for k, v in sp["device_ms"].items())
               + f"; idle share {sp['idle_share']:.3f}; top kernels (ms, "
               f"launches, name): " + "; ".join(
                   f"{ms:.3f} {n} {name}" for ms, n, name in
                   sp["top_kernels"])))
        rs, par = r["restart"], r["parity"]
        log(f"[lm_train] {arch} restart: failure injected at step "
            f"{rs['fail_at']}, checkpoints every {rs['ckpt_every']}, "
            f"{rs['steps_replayed']} step(s) replayed on the same batches; "
            f"resumed from the checkpointed state bit for bit (fingerprints "
            f"of every leaf); losses after the restore within "
            f"{rs['loss_rel_err']:.3g} (<= {TRAIN_LOSS_RTOL}); final params "
            f"off the uninjected run's by at most "
            f"{max(d['share'] for d in rs['drift'].values()):.3g} of the "
            f"distance moved (<= {RESTART_PARAM_SHARE}); {rs['checkpoints']} "
            f"checkpoints of {rs['checkpoint_bytes']} B written under "
            f"{rs['ckpt_root']} ({rs['bytes_written']} B); "
            f"{rs['wall_s']:.1f} s")
        if "grad_max_abs_err_vs_f64" in par:
            dist = par["plain_relative_distance"]
            grads = (f"grads held to the float64 plain path (plain f32 path's "
                     f"worst relative distance {dist:.3g}; max abs err "
                     + ", ".join(
                         f"{k} {v:.3g}" for k, v in
                         par["grad_max_abs_err_vs_f64"].items()) + ")")
            rt = par["routing"]
            grads += (f"; routing of the kernel path and of the float64 "
                      f"path equal to the plain path's ("
                      f"{rt['kernel_vs_plain']['near_ties']} / "
                      f"{rt['float64_vs_plain']['near_ties']} near ties, "
                      f"smallest margin "
                      f"{rt['kernel_vs_plain']['min_margin']:.3g})")
        else:
            grads = (f"grads within rtol {TRAIN_GRAD_TOL[0]}, atol "
                     f"{TRAIN_GRAD_TOL[1]} x max|g| (max abs err "
                     + ", ".join(f"{k} {v:.3g}" for k, v in
                                 par["grad_max_abs_err"].items()) + ")")
        log(f"[lm_train] {arch} first step in f32 at {par['batch']} x "
            f"{par['seq']} tokens, kernel path vs plain path: loss "
            f"{par['loss']:.7f} vs {par['plain_loss']:.7f} (rel err "
            f"{par['loss_rel_err']:.3g} <= {TRAIN_LOSS_RTOL}); {grads}; "
            f"{par['wall_s']:.1f} s")


def moe_slice(device, workdir: str) -> dict:
    """``main``'s phases 15d-15f, also run alone to rehearse them:
    ``[moe]`` (:func:`phase_moe`), ``[lm_train]`` (:func:`phase_lm_train`)
    with K2's counts and K3's zeroed just before and read just after,
    then K2 and its backward at the MoE combine's shapes
    (:func:`moe_k2_shapes`: held bit for bit, timed, CUDA launches per
    call counted in a fresh process) and K3 at the MoE LMs' served
    shapes (``MOE_K3_SHAPES``)."""
    # phase 15d: [moe] qwen2-moe-a2.7b served at full width and depth,
    # dbrx-132b at full width on 6 layers; K3's and K2's counts zeroed
    # just before each served run and read just after (moe_served)
    gc.collect()
    torch.cuda.empty_cache()
    moe = phase_moe(device)
    moe_k3, moe_k2 = moe["k3_launches"], moe["k2_launches"]
    assert moe_k3 > 0 and moe_k2 > 0
    log_moe(moe)
    log(f"[moe] main-path launches: K3 {moe_k3}, K2 {moe_k2}; phase wall "
        f"{moe['wall_s']:.1f} s")

    # phase 15e: [lm_train] smollm-360m at full width and depth and
    # qwen2-moe-a2.7b at full width on 2 layers; K2's counts and K3's
    # zeroed just before and read just after (training takes the
    # plain attention: K3 has no backward)
    gc.collect()
    torch.cuda.empty_cache()
    segment_sum.launches = segment_sum.grad_launches = 0
    flash_attention.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_",
                                     dir=LM_CKPT_ROOT) as ckpt_root:
        lmt = phase_lm_train(device, workdir, ckpt_root=ckpt_root)
    lmt_k2, lmt_k2b = segment_sum.launches, segment_sum.grad_launches
    assert (lmt_k2, lmt_k2b) == (lmt["k2_launches"],
                                 lmt["k2_grad_launches"]), \
        (lmt_k2, lmt_k2b, lmt["k2_launches"], lmt["k2_grad_launches"])
    assert lmt_k2 > 0 and lmt_k2b > 0 and flash_attention.launches == 0
    log_lm_train(lmt)
    log(f"[lm_train] main-path launches: K2 forward {lmt_k2}, K2 "
        f"backward {lmt_k2b}, K3 0; phase wall "
        f"{sum(r['wall_s'] for r in lmt['models'].values()):.1f} s")

    # phase 15f: K2 (and its backward) at the MoE combine's shapes, held
    # to the plain version bit for bit (integer messages), timed, with
    # CUDA launches per call counted in a fresh process; K3 at the MoE
    # LMs' served shapes
    shapes = moe_k2_shapes(moe, lmt)
    k2m_checks = check_k2_shapes(shapes)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    gc.collect()
    torch.cuda.empty_cache()
    fresh = fresh_k2_launches(
        {**{label: (ids_t, n, d, False)
            for label, (ids_t, n, d, _) in shapes.items()},
         **{f"{label}_backward": (ids_t, n, d, True)
            for label, (ids_t, n, d, bwd) in shapes.items() if bwd}},
        workdir, MOE_K3_SHAPES)
    flush = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
    k2m = {}
    for label, (ids_t, n, d, backward) in shapes.items():
        r = k2m[label] = measure_segment_sum_full_graph(
            ids_t, n, (d,), flush, gen)["widths"][d]
        r["checks"] = k2m_checks[label]["checks"]
        r["cuda_launches_per_call"] = fresh[label]
        if backward:
            r["backward"] = measure_segment_sum_grad(ids_t, d, n, flush,
                                                     gen)
            r["backward"]["cuda_launches_per_call"] = \
                fresh[f"{label}_backward"]
        log_k2_shape(label, r)
        log(f"[kernel] segment_sum {label}: CUDA launches per call "
            f"(profiler, {TRACE_CALLS} calls in a fresh process): "
            + ", ".join(f"{k} {fresh[k]}" for k in fresh
                        if k.startswith(label)))
    k3m = {}
    for kind in MOE_K3_SHAPES:
        r = k3m[kind] = measure_flash(kind, flush, gen, MOE_K3_SHAPES,
                                      count_launches=False)
        r["cuda_launches_per_call"] = fresh[kind] and fresh[kind][0]
        log(f"[kernel] flash_attention {kind} ({r['design']}, nsplit "
            f"{r['nsplit']}, CUDA launches per call (profiler) "
            f"{r['cuda_launches_per_call'] or 'not measured'}) "
            f"{r['dtype']} q[{r['b']},{r['hq']},{r['sq']},{r['dh']}] over "
            f"{r['kv_len']} keys x {r['hkv']} heads: kernel "
            f"{r['ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})  {r['tflop_per_s']:.2f} TFLOP/s  "
            f"{r['gb_per_s']:.1f} GB/s  plain {r['plain_ms']:.4f} ms  "
            + "  ".join(f"{name} {t:.4f} ms"
                        for name, t in r["library"].items())
            + f"  max_abs_err {r['max_abs_err']:.3g}")
    del flush, shapes
    for r in moe["models"].values():
        r.pop("combine_ids")
    for r in lmt["models"].values():
        r.pop("combine_ids", None)
    gc.collect()
    torch.cuda.empty_cache()

    return {"moe": moe, "lm_train": lmt, "k2": k2m, "k3": k3m,
            "lm_train_k2": lmt_k2, "lm_train_k2_grad": lmt_k2b}


# ---------------------------------------------------------------------------
# [din]: DIN served, scored and trained at full width (10M-item catalog)
# ---------------------------------------------------------------------------

#: DIN's logits on the card against the plain CPU f32 path on the same
#: requests (rtol and atol), as GCN's
DIN_TOL = 1e-5
#: ``[din]``'s sizes: ``serve_p99``'s requests of ``batch``, the
#: ``serve_bulk`` batch, the retrieval candidates (the shape's 1,000,000
#: cut to 262,144: unchunked, its transients are ~4x ``serve_bulk``'s
#: and do not fit in 80 GB), ``train_batch``'s examples a step, the
#: first step's gradient-parity batch, the AdamW steps, the compressed
#: steps, the steps on one repeated batch (where the loss must fall), and
#: the restart's checkpoint interval and injected failure
DIN_SIZES = dict(requests=64, batch=512, bulk=262_144, candidates=262_144,
                 train_batch=65_536, parity_batch=8192, steps=10,
                 compress_steps=3, repeat_steps=3, ckpt_every=5, fail_at=7)


def to_cpu(tree):
    """A detached CPU copy of every tensor leaf of ``tree``."""
    return tree_map(lambda t: t.detach().to("cpu"), tree)


@contextlib.contextmanager
def recorded_din_batches(batches: list):
    """Every batch ``din.forward`` scores appended (by reference) to
    ``batches``: what ``serve_din`` drew, to hold its logits to the plain
    CPU path on the same requests."""
    from repro_torch.models.recsys import din

    forward = din.forward

    def recording(params, batch, cfg):
        batches.append(batch)
        return forward(params, batch, cfg)

    din.forward = recording
    try:
        yield
    finally:
        din.forward = forward


def din_close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """``got`` (logits on the card) finite and within ``DIN_TOL`` of
    ``want`` (the plain CPU path's); returns the max abs error."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert got.shape == want.shape and bool(torch.isfinite(got).all()) and \
        torch.allclose(got, want, rtol=DIN_TOL, atol=DIN_TOL), \
        f"{what}: max abs err {err} beyond {DIN_TOL} of the plain CPU path"
    return err


def check_decoded_ids(ids: torch.Tensor, packed: np.ndarray, b: int) -> int:
    """The request ids K1 decoded equal, as int64, the host decode
    (``core/compbin.py::decode_ids``) of the same packed bytes; returns
    how many."""
    from repro_torch.core import compbin as core_compbin

    want = core_compbin.decode_ids(packed, b).astype(np.int64)
    got = ids.detach().cpu().numpy()
    assert got.dtype == np.int64 and np.array_equal(got, want), \
        "K1's decoded request ids differ from decode_ids"
    return int(want.size)


def din_packed_serve(cfg, params, device, *, batch: int, n_requests: int,
                     seed: int = 0) -> dict:
    """``serve_p99``'s traffic as ``examples/serve_din_requests.py`` sends
    it: per request the history and candidate item ids drawn from
    ``np.random.default_rng(seed)`` in [0, n_items) and CompBin-packed at
    ``b = bytes_per_vertex(n_items)`` (3 for 10M items) off the clock;
    timed: ONE host-to-device copy of the packed bytes, K1's decode of
    ``batch * (seq_len + 1)`` ids, categories as ``id % n_cates``, the
    forward.  After the timed loop the decoded ids are held to
    ``decode_ids`` and every request's logits to the plain CPU path."""
    from repro_torch.core import compbin as core_compbin
    from repro_torch.models.recsys import din

    on_gpu = torch.device(device).type == "cuda"
    b = core_compbin.bytes_per_vertex(cfg.n_items)
    rng = np.random.default_rng(seed)
    n_hist = batch * cfg.seq_len
    lat, sent, decoded, logits = [], [], [], []
    host0, k1_0 = core_compbin.host_decoded_bytes(), compbin_decode.launches
    with torch.inference_mode():
        for _ in range(n_requests):
            hist = rng.integers(0, cfg.n_items, (batch, cfg.seq_len))
            cand = rng.integers(0, cfg.n_items, batch)
            packed = np.concatenate([
                core_compbin.encode_ids(hist.reshape(-1).astype(np.uint64),
                                        b),
                core_compbin.encode_ids(cand.astype(np.uint64), b)])
            _cuda_sync(device)
            t0 = time.perf_counter()
            ids = compbin_decode(torch.from_numpy(packed).to(device),
                                 b).long()
            h, c = ids[:n_hist].view(batch, cfg.seq_len), ids[n_hist:]
            out = din.forward(params, {"hist_items": h,
                                       "hist_cates": h % cfg.n_cates,
                                       "cand_item": c,
                                       "cand_cate": c % cfg.n_cates}, cfg)
            _cuda_sync(device)
            lat.append(time.perf_counter() - t0)
            sent.append(packed)
            decoded.append(ids)
            logits.append(out)
    launches = compbin_decode.launches - k1_0
    assert core_compbin.host_decoded_bytes() == host0, "host decode"
    assert launches == (n_requests if on_gpu else 0), launches
    ids_checked = sum(check_decoded_ids(ids, packed, b)
                      for ids, packed in zip(decoded, sent))
    cpu_params, worst = to_cpu(params), 0.0
    with torch.inference_mode():
        for i, ids in enumerate(decoded):
            ids = ids.cpu()
            h, c = ids[:n_hist].view(batch, cfg.seq_len), ids[n_hist:]
            want = din.forward(cpu_params, {
                "hist_items": h, "hist_cates": h % cfg.n_cates,
                "cand_item": c, "cand_cate": c % cfg.n_cates}, cfg)
            worst = max(worst, din_close(logits[i], want,
                                         f"packed request {i}"))
    wire = sum(p.nbytes for p in sent)
    ms = np.array(lat[1:]) * 1e3
    return {"b": b, "ids_per_request": n_hist + batch,
            "latencies_s": lat, "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "wire_bytes": wire, "int32_bytes": wire // b * 4,
            "k1_launches": launches, "ids_checked": ids_checked,
            "max_abs_err": worst}


def din_served(cfg, params, device, *, batch: int, n_requests: int,
               check_rows: int = 512) -> dict:
    """``serve_din`` (``n_requests`` of ``batch``; the first dropped from
    its p50 / p99) with every request recorded; each request's first
    ``check_rows`` logits held to the plain CPU path on the same
    request."""
    from repro_torch.launch import serve as sv
    from repro_torch.models.recsys import din

    seen = []
    with recorded_din_batches(seen):
        logits, timings = sv.serve_din(cfg, batch=batch,
                                       n_requests=n_requests, device=device,
                                       params=params)
    assert logits.shape == (n_requests, batch), logits.shape
    cpu_params, worst = to_cpu(params), 0.0
    with torch.inference_mode():
        for i, b in enumerate(seen):
            rows = {k: v[:check_rows].cpu() for k, v in b.items()}
            want = din.forward(cpu_params, rows, cfg)
            worst = max(worst, din_close(
                torch.from_numpy(logits[i][:check_rows]), want,
                f"request {i}"))
    return {**timings, "max_abs_err": worst,
            "rows_checked": n_requests * min(check_rows, batch),
            "finite": bool(np.isfinite(logits).all())}


def din_retrieval(cfg, params, device, *, candidates: int,
                  check_rows: int = 512, seed: int = 3) -> dict:
    """``score_candidates``: one user's history (seq_len ids, -1 padding
    drawn) against ``candidates`` candidates in one call, timed after a
    warm-up call on ``check_rows`` of them; the first ``check_rows``
    scores held to the plain CPU path."""
    from repro_torch.models.recsys import din

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=torch.int64).to(device)

    batch = {"hist_items": t(rng.integers(-1, cfg.n_items, cfg.seq_len)),
             "hist_cates": t(rng.integers(0, cfg.n_cates, cfg.seq_len)),
             "cand_items": t(rng.integers(0, cfg.n_items, candidates)),
             "cand_cates": t(rng.integers(0, cfg.n_cates, candidates))}
    head = {**batch, "cand_items": batch["cand_items"][:check_rows],
            "cand_cates": batch["cand_cates"][:check_rows]}
    with torch.inference_mode():
        din.score_candidates(params, head, cfg)              # warm-up
        _cuda_sync(device)
        t0 = time.perf_counter()
        scores = din.score_candidates(params, batch, cfg)
        _cuda_sync(device)
        secs = time.perf_counter() - t0
        want = din.score_candidates(to_cpu(params), to_cpu(head), cfg)
    assert scores.shape == (candidates,), scores.shape
    err = din_close(scores[:check_rows], want, "retrieval scores")
    assert bool(torch.isfinite(scores).all()), "non-finite scores"
    return {"candidates": candidates, "s": secs, "max_abs_err": err}


def _din_kernel_class(name: str) -> str:
    low = name.lower()
    if any(w in low for w in ("index", "gather", "radix", "sort")):
        return "gather"
    return _kernel_class(name)


def din_step_split(cfg, state, batch, opt_cfg) -> dict:
    """Where one DIN training step spends the card's time, in the step's
    two halves, each under the profiler (:func:`profile_device`): the
    loss and its gradients (GEMMs; the table gather and its backward:
    ``index`` / ``indexing_backward`` and their sorts; copies; the rest:
    elementwise, concatenations, the dense gradient's fill, the loss),
    then AdamW's update (all of it elementwise); None where the trace
    holds no device time."""
    from repro_torch.models.recsys import din

    grads = {}

    def loss_and_backward():
        p = tree_map(lambda v: v.detach().requires_grad_(), state["params"])
        loss = din.loss_fn(p, batch, cfg)
        grads["g"] = tree_unflatten(p, torch.autograd.grad(
            loss, tree_leaves(p)))

    wall_a, sums_a, top_a = profile_device(
        loss_and_backward, _din_kernel_class,
        ("gemm", "gather", "copy", "other"))
    wall_b, sums_b, top_b = profile_device(
        lambda: adamw_update(state["params"], grads.pop("g"), state["opt"],
                             opt_cfg),
        _kernel_class, ("gemm", "copy", "other"))
    dev = {"gemm": sums_a["gemm"], "gather": sums_a["gather"],
           "adamw": sum(sums_b.values()),
           "rest": sums_a["copy"] + sums_a["other"]}
    wall = (wall_a + wall_b) * 1e3
    busy = sum(dev.values())
    return {"wall_ms": wall, "device_ms": dev if busy else None,
            "idle_share": 1 - busy / wall if busy else None,
            "top_kernels": sorted(top_a + top_b, reverse=True)[:8],
            "gather_kernels": sorted(
                (k for k in top_a if _din_kernel_class(k[2]) == "gather"),
                reverse=True)}


def check_loss_falls(losses: list) -> None:
    """On one repeated batch each step's loss below the one before."""
    assert len(losses) >= 2 and np.isfinite(losses).all() and all(
        b < a for a, b in zip(losses, losses[1:])), \
        f"the loss does not fall on a repeated batch: {losses}"


def din_parity_check(loss: float, plain_loss: float, grads: dict,
                     plain_grads: dict, exact: dict) -> dict:
    """The first step on the card against the plain CPU f32 path: the
    loss within ``TRAIN_LOSS_RTOL``; each gradient held by
    :func:`exact_close` to the float64 run (``exact``) at the plain
    path's :func:`relative_distance` from it (f32 GEMMs round otherwise
    on the card than on the CPU)."""
    assert abs(loss - plain_loss) <= TRAIN_LOSS_RTOL * abs(plain_loss), \
        f"first-step loss {loss} != the plain CPU path's {plain_loss}"
    scale = relative_distance(plain_grads, exact)
    return {"loss": loss, "plain_loss": plain_loss,
            "loss_rel_err": abs(loss - plain_loss) / abs(plain_loss),
            "plain_relative_distance": scale,
            "grad_max_abs_err_vs_f64": {
                k: exact_close(grads[k], x, scale, f"first-step grad {k}")
                for k, x in exact.items()}}


def din_first_step(cfg, params, batch, device) -> dict:
    """:func:`din_parity_check` on ``batch``: the loss and gradients on
    ``device`` in f32, on CPU copies in f32, and on ``device`` in
    float64."""
    from repro_torch.models.recsys import din

    def loss_fn(b):
        return lambda p: din.loss_fn(p, b, cfg)

    loss, grads = loss_and_grads(loss_fn(batch), params)
    plain_loss, plain = loss_and_grads(loss_fn(to_cpu(batch)),
                                       to_cpu(params))
    _, exact = loss_and_grads(loss_fn(batch),
                              tree_map(torch.Tensor.double, params))
    return din_parity_check(loss, plain_loss, grads,
                            {k: v.to(device) for k, v in plain.items()},
                            exact)


@contextlib.contextmanager
def checked_ef(calls: list):
    """Every ``ef_compress_psum`` call of the compressed step checked as
    it returns: per leaf the new residual finite and within half the
    quantisation step, ``|e| <= scale / 2`` (scale = the group's amax of
    grad + residual over the levels, plus one f32 rounding of that
    amax), and at a world of one the mean equal to grad + residual - e
    within two such roundings.  ``calls`` gets, per call, the worst
    ``|e| / (scale / 2)`` and the bytes the int8 sum sent against
    f32's."""
    import torch.distributed as dist

    from repro_torch.optim import compression

    fn = compression.ef_compress_psum

    def checking(grads, ef, group=None, *, axis_size, outer_group=None):
        mean, new = fn(grads, ef, group, axis_size=axis_size,
                       outer_group=outer_group)
        levels = max(1, 127 // axis_size)
        one = dist.get_world_size(group) == 1 and outer_group is None
        worst, n = 0.0, 0
        for g, e, m, e2 in zip(tree_leaves(grads), tree_leaves(ef),
                               tree_leaves(mean), tree_leaves(new)):
            x = g.float() + e
            amax = x.abs().max().reshape(1)
            dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
            amax = float(amax[0])
            half = max(amax, 1e-12) / levels / 2
            slack = float(torch.finfo(torch.float32).eps) * amax
            emax = float(e2.abs().max())
            assert math.isfinite(emax), "ef residual not finite"
            assert emax <= half + slack, \
                f"ef residual {emax} beyond half the quantisation step {half}"
            if one:
                off = float((m - (x - e2)).abs().max())
                assert off <= 2 * slack, \
                    f"compressed mean off grad + residual - e by {off}"
            worst = max(worst, emax / half)
            n += g.numel()
        calls.append({"leaves": len(tree_leaves(grads)), "elements": n,
                      "worst_residual_share": worst, "int8_bytes": n,
                      "f32_bytes": 4 * n})
        return mean, new

    compression.ef_compress_psum = checking
    try:
        yield
    finally:
        compression.ef_compress_psum = fn


def din_train(cfg, device, workdir: str, *, train_batch: int,
              parity_batch: int, steps: int, compress_steps: int,
              repeat_steps: int, ckpt_every: int, fail_at: int,
              seed: int = 0) -> dict:
    """DIN trained through the training CLI's pieces (``launch/train.py``:
    ``_din_batches``, ``_make_step`` with the JAX package's AdamW config,
    ``process_group`` and the compressed step):

    1. ``steps`` timed steps on fresh batches of ``train_batch``: finite
       losses (the labels are independent of the ids, so over fresh
       batches the loss cannot fall below ~ln 2); the first step's loss
       held to the plain CPU f32 path on the same params and batch (a
       forward) within ``TRAIN_LOSS_RTOL``; peak memory; one more step
       profiled (:func:`din_step_split`); then ``repeat_steps`` steps on
       one repeated batch, where the loss must fall;
    2. the restart (a failure at ``fail_at``, checkpoints every
       ``ckpt_every``, the batches replayed from the restored step) held
       to step 1's run by :func:`check_restart`;
    3. the first step's gradients at ``parity_batch``
       (:func:`din_first_step`);
    4. ``compress_steps`` steps with ``--compress-grads`` on a world of
       one (NCCL on the card), every residual checked
       (:func:`checked_ef`)."""
    from repro_torch.distributed.fault_tolerance import ResilientTrainer
    from repro_torch.launch import train as tr
    from repro_torch.models.recsys import din
    from repro_torch.optim import AdamWConfig, adamw_init, ef_state_init

    on_gpu = torch.device(device).type == "cuda"
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps,
                          master_f32=True)
    init_fn, step = tr._make_step("din", cfg, opt_cfg, "recsys",
                                  device=device)
    t0 = time.perf_counter()
    source = tr._din_batches(cfg, train_batch, device=device)
    batches = [next(source) for _ in range(steps + 1)]
    draw_s = time.perf_counter() - t0
    if on_gpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    # 1. the timed steps, the first step's loss, the split, a repeated batch
    state = {"params": init_fn(seed)}
    state["opt"] = adamw_init(state["params"], opt_cfg)
    start = to_cpu(state["params"])
    losses, secs = [], []
    for b in batches[:steps]:
        t0 = time.perf_counter()
        state, met = step(state, b)
        losses.append(float(met["loss"]))
        _cuda_sync(device)
        secs.append(time.perf_counter() - t0)
    assert np.isfinite(losses).all(), losses
    peak = torch.cuda.max_memory_allocated(device) if on_gpu else None
    with torch.no_grad():
        plain_first = float(din.loss_fn(start, to_cpu(batches[0]), cfg))
    first_err = abs(losses[0] - plain_first) / abs(plain_first)
    assert first_err <= TRAIN_LOSS_RTOL, \
        f"first-step loss {losses[0]} != the plain CPU path's {plain_first}"
    out = {"batch": train_batch, "seq": cfg.seq_len, "draw_s": draw_s,
           "params": sum(t.numel() for t in tree_leaves(state["params"])),
           "state_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(state)),
           "losses": losses, "step_s": secs,
           "step_p50_s": statistics.median(secs[1:]),
           "first_loss_plain": plain_first, "first_loss_rel_err": first_err,
           "max_memory_allocated": peak}
    if on_gpu:
        out["step_split"] = din_step_split(cfg, state, batches[steps],
                                           opt_cfg)
    repeat, rep_losses = state, []
    for _ in range(repeat_steps):
        repeat, met = step(repeat, batches[steps])
        rep_losses.append(float(met["loss"]))
    check_loss_falls(rep_losses)
    out["repeated_batch_losses"] = rep_losses
    clean = {"params": to_cpu(state["params"])}
    del state, repeat
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()

    # 2. the restart on the same batches replayed
    t_restart = time.perf_counter()
    resume = (fail_at // ckpt_every) * ckpt_every
    ckpt_dir = os.path.join(workdir, "din_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    inputs, seen = {}, []

    def recording(st, b):
        n = recording.calls
        recording.calls += 1
        if n in (resume, fail_at):
            inputs[n] = state_fingerprint(st)
        return step(st, b)

    recording.calls = 0
    first = {"params": init_fn(seed)}
    first["opt"] = adamw_init(first["params"], opt_cfg)
    trainer = ResilientTrainer(recording, first, ckpt_dir=ckpt_dir,
                               ckpt_every=ckpt_every, keep_last=1)
    del first
    restored = trainer.run(
        iter(batches[:fail_at + 1] + batches[resume:steps]), n_steps=steps,
        inject_failure_at=fail_at,
        on_metrics=lambda s, m: seen.append((s, float(m["loss"]))))
    ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(ckpt_dir) for f in fs)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    assert [s for s, _ in seen] == list(range(1, fail_at + 1)) + list(
        range(resume + 1, steps + 1)), seen
    restored = {"params": restored["params"]}
    del trainer
    gc.collect()
    on_dev = lambda tree: tree_map(lambda t: t.to(device), tree)  # noqa: E731
    out["restart"] = {"fail_at": fail_at, "ckpt_every": ckpt_every,
                      "steps_replayed": fail_at - resume,
                      "checkpoint_bytes": ckpt_bytes,
                      **check_restart(inputs[fail_at], inputs[resume],
                                      [x for _, x in seen[fail_at:]],
                                      losses[resume:], restored,
                                      {"params": on_dev(clean["params"])},
                                      on_dev(start))}
    del restored, clean, inputs
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()
    out["restart"]["wall_s"] = time.perf_counter() - t_restart

    # 3. the first step's gradients at the parity batch
    t_parity = time.perf_counter()
    pb = {k: v[:parity_batch] for k, v in batches[0].items()}
    out["parity"] = {"batch": parity_batch,
                     **din_first_step(cfg, on_dev(start), pb, device),
                     "wall_s": time.perf_counter() - t_parity}
    del start

    # 4. --compress-grads on a world of one
    calls, closses, csecs = [], [], []
    with tr.process_group(device) as group:
        backend = str(torch.distributed.get_backend(group))
        _, cstep = tr._make_step("din", cfg, opt_cfg, "recsys", True,
                                 device=device)
        state = {"params": init_fn(seed)}
        state["opt"] = adamw_init(state["params"], opt_cfg)
        state["ef"] = ef_state_init(state["params"])
        with checked_ef(calls):
            for b in batches[:compress_steps]:
                t0 = time.perf_counter()
                state, met = cstep(state, b)
                closses.append(float(met["loss"]))
                _cuda_sync(device)
                csecs.append(time.perf_counter() - t0)
    assert len(calls) == compress_steps and np.isfinite(closses).all()
    assert all(bool(torch.isfinite(e).all())
               for e in tree_leaves(state["ef"]))
    out["compressed"] = {"backend": backend, "losses": closses,
                         "step_s": csecs,
                         "step_p50_s": statistics.median(csecs),
                         "ef_calls": calls}
    # the item-table gradient's ids (one step's history), for
    # :func:`din_table_grad`
    out["table_grad_ids"] = batches[0]["hist_items"].reshape(-1)
    del state, batches
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()
    return out


def phase_din(device, workdir: str, *, reduced: bool = False,
              sizes: dict = None, seed: int = 0) -> dict:
    """``[din]``: DIN at full width (embed 18, seq 100, attention MLP
    80-40, final MLP 200-80, 10,000,000 items x 10,000 categories; the
    reduced config with ``reduced``), its parameters drawn on the card:

    - ``serve_p99``: ``requests`` x ``batch`` through ``serve_din``
      (:func:`din_served`), then the same count with the item ids
      CompBin-packed as the repo's DIN request example sends them, K1
      decoding them on the card (:func:`din_packed_serve`);
    - ``serve_bulk``: one batch of ``bulk`` through ``serve_din``;
    - retrieval: one user against ``candidates`` (:func:`din_retrieval`);
    - training (:func:`din_train`).

    Every logit on the card is held to the plain CPU f32 path; K1's
    launches are the packed requests (``k1_launches``)."""
    from repro_torch.configs.shapes import RecsysShape
    from repro_torch.launch.model_flops import din_model_flops
    from repro_torch.models.recsys import din

    t_start = time.perf_counter()
    sz = {**DIN_SIZES, **(sizes or {})}
    on_gpu = torch.device(device).type == "cuda"
    spec = get_arch("din")
    cfg = spec.make_reduced() if reduced else spec.make_config()
    t0 = time.perf_counter()
    params = din.init_params(cfg, torch.Generator(device=device)
                             .manual_seed(seed))
    _cuda_sync(device)
    out = {"config": {k: getattr(cfg, k) for k in (
        "name", "embed_dim", "seq_len", "n_items", "n_cates", "attn_mlp",
        "mlp")},
        "params": sum(t.numel() for t in tree_leaves(params)),
        "param_bytes": sum(t.numel() * t.element_size()
                           for t in tree_leaves(params)),
        "init_s": time.perf_counter() - t0, "sizes": sz}

    def flops(kind, batch, n=0):
        return din_model_flops(cfg, RecsysShape(kind, batch, kind, n))

    out["serve"] = din_served(cfg, params, device, batch=sz["batch"],
                              n_requests=sz["requests"])
    out["serve"]["flops"] = flops("serve", sz["batch"])
    out["packed"] = din_packed_serve(cfg, params, device, batch=sz["batch"],
                                     n_requests=sz["requests"], seed=seed)
    if on_gpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    bulk = din_served(cfg, params, device, batch=sz["bulk"], n_requests=2)
    bulk.update(s=bulk["latencies_s"][1], flops=flops("serve", sz["bulk"]),
                max_memory_allocated=(torch.cuda.max_memory_allocated(device)
                                      if on_gpu else None))
    bulk["flops_per_s"] = bulk["flops"] / bulk["s"]
    out["bulk"] = bulk
    if on_gpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    ret = din_retrieval(cfg, params, device, candidates=sz["candidates"])
    ret.update(flops=flops("retrieval", 1, sz["candidates"]),
               max_memory_allocated=(torch.cuda.max_memory_allocated(device)
                                     if on_gpu else None))
    ret["flops_per_s"] = ret["flops"] / ret["s"]
    out["retrieval"] = ret
    del params
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()
    out["train"] = din_train(
        cfg, device, workdir, seed=seed, **{k: sz[k] for k in (
            "train_batch", "parity_batch", "steps", "compress_steps",
            "repeat_steps", "ckpt_every", "fail_at")})
    out["train"]["flops"] = flops("train", sz["train_batch"])
    out["k1_launches"] = out["packed"]["k1_launches"]
    out["wall_s"] = time.perf_counter() - t_start
    return out


def log_din(r: dict) -> None:
    """The ``[din]`` lines."""
    c, s, p, bk, rt, tr = (r["config"], r["serve"], r["packed"], r["bulk"],
                           r["retrieval"], r["train"])
    sz = r["sizes"]
    log(f"[din] {c['name']} (embed {c['embed_dim']}, seq {c['seq_len']}, "
        f"attention MLP {c['attn_mlp']}, MLP {c['mlp']}, {c['n_items']} "
        f"items x {c['n_cates']} categories): {r['params']} parameters, "
        f"{r['param_bytes']} B f32, drawn on the device in "
        f"{r['init_s']:.2f} s")
    log(f"[din] serve_p99: {sz['requests']} requests of {sz['batch']} "
        f"through serve_din: p50 {s['p50_ms']:.3f} ms, p99 "
        f"{s['p99_ms']:.3f} ms (requests 2..{sz['requests']}), "
        f"{s['flops'] / (s['p50_ms'] * 1e-3) / 1e12:.3f} TFLOP/s at p50; "
        f"logits within {DIN_TOL} of the plain CPU path on "
        f"{s['rows_checked']} rows (max abs err {s['max_abs_err']:.3g})")
    log(f"[din] serve_p99 packed: the same count, item ids CompBin-packed "
        f"at b={p['b']} ({p['ids_per_request']} ids a request), one H2D "
        f"copy + K1 + forward: p50 {p['p50_ms']:.3f} ms, p99 "
        f"{p['p99_ms']:.3f} ms; wire {p['wire_bytes']} B against "
        f"{p['int32_bytes']} B as int32 "
        f"({100 * (1 - p['wire_bytes'] / p['int32_bytes']):.1f} % less); "
        f"K1 launches {p['k1_launches']}; {p['ids_checked']} ids equal "
        f"decode_ids as int64; logits within {DIN_TOL} of the plain CPU "
        f"path (max abs err {p['max_abs_err']:.3g})")
    log(f"[din] serve_bulk: one batch of {sz['bulk']}: {bk['s'] * 1e3:.3f} "
        f"ms, {bk['flops']:.4g} FLOP by din_model_flops, "
        f"{bk['flops_per_s'] / 1e12:.3f} TFLOP/s; max_memory_allocated "
        f"{bk['max_memory_allocated']} B; first {min(512, sz['bulk'])} rows "
        f"within {DIN_TOL} of the plain CPU path (max abs err "
        f"{bk['max_abs_err']:.3g})")
    log(f"[din] retrieval: one user against {rt['candidates']} candidates "
        f"(the shape's 1,000,000 cut): {rt['s'] * 1e3:.3f} ms, "
        f"{rt['flops']:.4g} FLOP, {rt['flops_per_s'] / 1e12:.3f} TFLOP/s; "
        f"max_memory_allocated {rt['max_memory_allocated']} B; first "
        f"{min(512, rt['candidates'])} scores within {DIN_TOL} of the plain "
        f"CPU path (max abs err {rt['max_abs_err']:.3g})")
    log(f"[din] train_batch: {tr['batch']} x {tr['seq']} a step, "
        f"{len(tr['losses'])} AdamW steps on fresh batches (drawn in "
        f"{tr['draw_s']:.2f} s), {tr['params']} parameters, state "
        f"{tr['state_bytes']} B: loss {tr['losses'][0]:.6f} -> "
        f"{tr['losses'][-1]:.6f} (finite; the labels carry no signal, so "
        f"~ln 2); step p50 {tr['step_p50_s'] * 1e3:.3f} ms (steps "
        + ", ".join(f"{t * 1e3:.1f}" for t in tr["step_s"])
        + f" ms; {tr['flops']:.4g} FLOP a step, "
        f"{tr['flops'] / tr['step_p50_s'] / 1e12:.3f} TFLOP/s); "
        f"max_memory_allocated {tr['max_memory_allocated']} B; first-step "
        f"loss within {tr['first_loss_rel_err']:.3g} (<= {TRAIN_LOSS_RTOL}) "
        f"of the plain CPU path; on one repeated batch "
        + " -> ".join(f"{x:.6f}" for x in tr["repeated_batch_losses"]))
    sp = tr.get("step_split") or {}
    log(f"[din] one step (torch.profiler, its two halves): wall "
        f"{sp.get('wall_ms', float('nan')):.3f} ms; device "
        + ("not measured (no device time in the trace)"
           if not sp.get("device_ms") else ", ".join(
               f"{k} {v:.3f} ms" for k, v in sp["device_ms"].items())
           + f"; idle share {sp['idle_share']:.3f}; top kernels (ms, "
           f"launches, name): " + "; ".join(
               f"{ms:.3f} {n} {name}" for ms, n, name in
               sp["top_kernels"])))
    if sp.get("gather_kernels"):
        log("[din] one step's gather class (ms, launches, name): "
            + "; ".join(f"{ms:.3f} {n} {name}"
                        for ms, n, name in sp["gather_kernels"]))
    rs, par, cp = tr["restart"], tr["parity"], tr["compressed"]
    log(f"[din] restart: failure injected at step {rs['fail_at']}, "
        f"checkpoints every {rs['ckpt_every']} ({rs['checkpoint_bytes']} B "
        f"each), {rs['steps_replayed']} step(s) replayed; resumed from the "
        f"checkpointed state bit for bit; losses after the restore within "
        f"{rs['loss_rel_err']:.3g}; final params off the uninjected run's "
        f"by at most {max(d['share'] for d in rs['drift'].values()):.3g} of "
        f"the distance moved (<= {RESTART_PARAM_SHARE}); "
        f"{rs['wall_s']:.1f} s")
    log(f"[din] first step at {par['batch']} x {tr['seq']}: loss "
        f"{par['loss']:.7f} vs the plain CPU path's {par['plain_loss']:.7f} "
        f"(rel err {par['loss_rel_err']:.3g}); grads held to float64 (the "
        f"plain path's worst relative distance "
        f"{par['plain_relative_distance']:.3g}; max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in
                    par["grad_max_abs_err_vs_f64"].items()) + ")")
    log(f"[din] --compress-grads on a {cp['backend']} world of one: "
        f"{len(cp['losses'])} steps, loss " + ", ".join(
            f"{x:.6f}" for x in cp["losses"])
        + f"; step p50 {cp['step_p50_s'] * 1e3:.3f} ms; residual at most "
        f"{max(c['worst_residual_share'] for c in cp['ef_calls']):.4f} of "
        f"half the quantisation step; {cp['ef_calls'][0]['int8_bytes']} B "
        f"int8 on the wire a step against "
        f"{cp['ef_calls'][0]['f32_bytes']} B f32; phase wall "
        f"{r['wall_s']:.1f} s")


def din_slice(device, workdir: str) -> dict:
    """``main``'s phase 15g, also run alone to rehearse it: ``[din]``
    (:func:`phase_din`) with K1's count zeroed just before and read just
    after, then K1 timed at the packed request's shape."""
    gc.collect()
    torch.cuda.empty_cache()
    compbin_decode.launches = 0
    r = phase_din(device, workdir)
    k1_launches = compbin_decode.launches
    assert k1_launches == r["k1_launches"] > 0, (k1_launches, r)
    log_din(r)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    flush = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
    p = r["packed"]
    k1 = measure_kernel(random_packed(p["ids_per_request"], p["b"], gen),
                        p["b"], flush)
    log(f"[kernel] compbin_decode at the DIN request shape b={k1['b']} "
        f"n={k1['n']}: kernel {k1['ms']:.4f} ms  bound {k1['bound_ms']:.4f} "
        f"ms ({k1['bound_by']})  plain {k1['plain_ms']:.4f} ms  library "
        f"none; main-path launches {k1_launches}")
    tg = din_table_grad(r["train"].pop("table_grad_ids"),
                        r["config"]["n_items"], r["config"]["embed_dim"],
                        flush, gen)
    log(f"[din] item-table gradient, f32[{tg['e']},{tg['d']}] rows summed "
        f"by item id into [{tg['n']},{tg['d']}] ({tg['valid_edges']} valid "
        f"ids): autograd's index_put_(accumulate) {tg['autograd_ms']:.4f} ms; "
        f"K2 {tg['design']} {tg['ms']:.4f} ms ("
        + ", ".join(f"{m} {v['ms']:.4f}" for m, v in tg["designs"].items())
        + f"), bit for bit equal to its plain version on integer rows; "
        f"index_add_ {tg['library_ms']:.4f} ms; bound {tg['bound_ms']:.4f} "
        f"ms ({tg['bound_by']})")
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    return {"din": r, "k1": k1, "k1_launches": k1_launches,
            "table_grad": tg}


def din_table_grad(ids: torch.Tensor, n: int, d: int, flush,
                   gen: torch.Generator) -> dict:
    """The DIN item table's gradient at one training step's shape (the
    ``[B * S, d]`` history rows summed by item id into ``[n, d]``, ids of
    -1 dropped), as autograd computes it (``index_put_`` with
    accumulation into zeros, ids clamped as the forward's gather clamps
    them) beside K2 on the same contract (:func:`
    measure_segment_sum_full_graph`: both designs held bit for bit,
    timed, ``index_add_``), for the ROADMAP lever that would route it
    through K2.  Not on any path the port runs."""
    r = measure_segment_sum_full_graph(ids, n, (d,), flush, gen)["widths"][d]
    rows = torch.randn(ids.numel(), d, generator=gen, device="cuda")
    safe = (ids.clamp(0, n - 1),)
    rows = torch.where((ids >= 0)[:, None], rows, 0)
    r["autograd_ms"] = time_cuda(lambda: torch.zeros(
        n, d, device="cuda").index_put_(safe, rows, accumulate=True),
        flush=flush)
    return r


# ---------------------------------------------------------------------------
# [cells]: build_cell's cells, dry-run on the card mesh, then run on the
# card where the estimate fits
# ---------------------------------------------------------------------------

#: share of the card's free memory (``torch.cuda.mem_get_info``) a cell's
#: peak estimate may take for the cell to run
CELLS_MEM_SHARE = 0.9
#: variant cells dry-run and run beside the 40 baseline cells
CELL_VARIANTS = (("gcn-cora", "full_graph_sm", "edges_compbin"),
                 ("gcn-cora", "minibatch_lg", "edges_compbin"),
                 ("gcn-cora", "ogb_products", "gcn_transform_first"))
#: shapes whose baseline GNN cells' first step is held to the plain path
#: (the ``edges_compbin`` cells' first step is held on every shape)
CELL_PARITY_SHAPES = ("full_graph_sm", "molecule")
#: the full-width PNA, MeshGraphNet and DimeNet cells' first-step
#: gradients against the float64 plain path: within this share of each
#: parameter's max|g|.  On these cells the f32 paths' own distance from
#: float64 moves 2-8x between two runs of the same path (the atomics'
#: order): the plain path 2.4e-5 / 2.0e-4 on MeshGraphNet's
#: full_graph_sm, up to 4.5e-4 on its molecule; the kernel path 1.1e-5
#: to 4.5e-4 (NVIDIA H100 80GB HBM3, 700.00 W), so a bound scaled by one
#: run of the plain path (``exact_close``) fails by chance.  A dropped
#: edge or a wrong id moves a gradient by 1e-2 or more.
CELL_GRAD_SHARE = 2e-3
#: query rows of each K3 call of a run prefill held to float64
CELL_SHADOW_ROWS = 4
#: timed steps of a run cell (median), after one warm-up step
CELL_STEP_REPS = 3
#: the dry run's expected statuses over the whole catalog
CELL_STATUS = {"OK": 35, "SKIP": 5, "FAIL": 0}


def all_cell_jobs() -> list:
    """The 40 baseline cells and :data:`CELL_VARIANTS`, as
    ``(arch, shape, variant)``."""
    from repro_torch.configs import all_cells
    return [(a, s, "baseline") for a, s in all_cells()] + list(CELL_VARIANTS)


def lm_lookup_flops(cfg, shape) -> float:
    """The part of ``lm_model_flops`` no program does as arithmetic: the
    formula prices every parameter at 2 FLOPs a token a pass, the
    embedding table too, which a program reads by lookup (untied: 6 V d
    a token to train, 2 V d to serve); and a prefill prices the LM head
    on every position, where the port computes the last one's logits
    only (2 V d for each of the other S - 1)."""
    v_d = cfg.vocab * cfg.d_model
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    embed = 0.0 if cfg.tie_embeddings else v_d * tokens * (
        6.0 if shape.kind == "train" else 2.0)
    head = 2.0 * v_d * shape.global_batch * (shape.seq_len - 1) \
        if shape.kind == "prefill" else 0.0
    return embed + head


def check_dry_run(recs: list, expect: dict | None = CELL_STATUS,
                  jobs: list | None = None) -> dict:
    """The dry run's own checks: no cell ``FAIL`` (and, given ``expect``,
    the status counts of the 40 baseline cells); on every LM cell the
    model FLOPs the program must do as arithmetic (``model_flops`` less
    :func:`lm_lookup_flops`) are at most the counted FLOPs -- a program
    cannot do less work than its model needs.  ``useful_ratio``
    (``model_flops`` / counted) is recorded as the roofline gives it,
    for the GNN cells too (their segment sums' adds are counted as
    elementwise work).  ``jobs``: the cells as :func:`phase_cells` got
    them, whose ``cfg_overrides`` size the LM configs."""
    from repro_torch.configs.shapes import LM_SHAPES

    fails = [f"{r['arch']}|{r['shape']}|{r.get('variant')}: "
             f"{r.get('error', '')[-300:]}" for r in recs
             if r["status"] == "FAIL"]
    assert not fails, "dry run FAIL: " + "; ".join(fails)
    base = [r for r in recs if r.get("variant", "baseline") == "baseline"]
    counts = {k: sum(r["status"] == k for r in base) for k in CELL_STATUS}
    if expect is not None:
        assert counts == expect, f"dry-run statuses {counts} != {expect}"
    for i, r in enumerate(recs):
        if r["status"] != "OK" or r["family"] != "lm":
            continue
        job = jobs[i] if jobs else ()
        over = job[3].get("cfg_overrides", {}) if len(job) > 3 else {}
        cfg = dataclasses.replace(get_arch(r["arch"]).make_config(), **over)
        arith = r["model_flops"] - lm_lookup_flops(cfg, LM_SHAPES[r["shape"]])
        r["arith_ratio"] = arith / r["cost"]["flops"]
        assert r["arith_ratio"] <= 1.0, \
            (f"{r['arch']}|{r['shape']}: the model needs {arith:.4g} FLOPs "
             f"of arithmetic, the trace counted {r['cost']['flops']:.4g}")
    return counts


def cell_params(cell, device, seed: int = 0) -> dict:
    """The cell's model weights drawn by its ``init_params`` from a
    generator on ``device``."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.recsys import din

    gen = torch.Generator(device=device).manual_seed(seed)
    family = get_arch(cell.arch_id).family
    if family == "lm":
        return tf.init_params(cell.cfg, gen, device=device)
    if family == "gnn":
        return steps._GNN_MODULES[cell.arch_id].init_params(
            cell.cfg, gen, device=device)
    return din.init_params(cell.cfg, gen, device=device)


def pack_ids(ids: torch.Tensor, b: int) -> torch.Tensor:
    """int64 ids as little-endian ``b``-byte CompBin words, -1 as the
    all-ones pad id: uint8[n * b]."""
    u = torch.where(ids < 0, (1 << (8 * b)) - 1, ids)
    return torch.stack([(u >> (8 * i)) & 255 for i in range(b)],
                       dim=1).to(torch.uint8).reshape(-1)


def _ids(n_real: int, n_slots: int, high: int, gen, device) -> torch.Tensor:
    """``n_slots`` int64 ids: the first ``n_real`` uniform in [0, high),
    -1 in the padding."""
    out = torch.full((n_slots,), -1, dtype=torch.int64, device=device)
    out[:n_real] = torch.randint(0, high, (n_real,), generator=gen,
                                 device=device)
    return out


def cell_batch(cell, device, seed: int = 0, lm_shape=None) -> tuple:
    """Inputs for ``cell.args[1]`` on ``device``: ``(batch, edge_ids)``.
    GNN (from ``seed``): edge ids uniform over the shape's real nodes (an
    Erdos-Renyi draw: the catalog fixes the sizes, not a degree law), -1
    in the padded slots (CompBin-packed under ``edges_compbin``; the
    int64 ids come back as ``edge_ids``), zero features on padded nodes,
    labels in range, masks on real nodes only, DimeNet's triplets over
    the real edges and its sorted graph ids.  DIN: the JAX package's
    draws, as the port's trainer and server make them
    (``launch/train.py::_din_batches``: history ids in [-1, n_items),
    categories, candidates and 0/1 labels uniform; a retrieval cell's one
    history and candidates by the same laws from ``seed``).  LM: tokens
    uniform in the vocabulary from ``seed`` (``lm_shape`` a smaller
    [B, S] for a rehearsal)."""
    from repro_torch.configs.shapes import GNN_SHAPES

    gen = torch.Generator(device=device).manual_seed(seed)
    specs, family = cell.args[1], get_arch(cell.arch_id).family
    if family == "lm":
        shape = lm_shape or tuple(specs["tokens"].shape)
        return {"tokens": torch.randint(0, cell.cfg.vocab, shape,
                                        generator=gen, device=device)}, None
    if family == "recsys":
        from repro_torch.launch.train import _din_batches
        cfg = cell.cfg
        if "cand_items" in specs:
            rng = np.random.default_rng(seed)
            n = specs["cand_items"].shape[0]
            draw = {"hist_items": rng.integers(-1, cfg.n_items, cfg.seq_len),
                    "hist_cates": rng.integers(0, cfg.n_cates, cfg.seq_len),
                    "cand_items": rng.integers(0, cfg.n_items, n),
                    "cand_cates": rng.integers(0, cfg.n_cates, n)}
            return {k: torch.as_tensor(v).to(device)
                    for k, v in draw.items()}, None
        batch = next(iter(_din_batches(cfg, specs["hist_items"].shape[0],
                                       device=device)))
        return {k: batch[k] for k in specs}, None
    shp = GNN_SHAPES[cell.shape_id]
    n, e = shp.n_nodes, shp.n_edges
    packed = specs["edge_src"].dtype == torch.uint8
    b = 0
    if packed:
        from repro_torch.core.compbin import bytes_per_vertex
        b = bytes_per_vertex(n)
    batch, edge_ids = {}, {}
    for key, spec in specs.items():
        size = tuple(spec.shape)
        if key in ("edge_src", "edge_dst"):
            slots = size[0] // b if packed else size[0]
            ids = _ids(e, slots, n, gen, device)
            edge_ids[key] = ids
            batch[key] = pack_ids(ids, b) if packed else ids.to(spec.dtype)
        elif key.startswith("triplet_"):
            batch[key] = _ids(min(size[0], int(shp.triplet_factor * e)),
                              size[0], e, gen, device).to(spec.dtype)
        elif key == "graph_id":
            g = torch.full(size, -1, dtype=torch.int64, device=device)
            g[:n] = torch.sort(torch.randint(0, shp.n_graphs, (n,),
                                             generator=gen,
                                             device=device)).values
            batch[key] = g.to(spec.dtype)
        elif key == "labels":
            batch[key] = torch.randint(0, cell.cfg.n_classes, size,
                                       generator=gen, device=device
                                       ).to(spec.dtype)
        elif spec.dtype == torch.bool:
            m = torch.rand(size, generator=gen, device=device) < 0.5
            m[n:] = False
            batch[key] = m
        else:
            x = torch.randn(size, generator=gen, device=device)
            if key in ("x", "pos"):
                x[n:] = 0.0
            batch[key] = x
    return batch, (edge_ids if packed else None)


def cell_expected(cell, asked: KernelRequests, on_gpu: bool = True) -> dict:
    """Each kernel's launches in one step of ``cell`` on the card: K1
    two (the packed edge ids) under ``edges_compbin``; K2 and its
    backward as the step's requests ``asked`` (:func:`kernel_requests`);
    K3 one a layer in a prefill; none in a DIN cell.  Off the card,
    none."""
    out = {"k1": 0, **asked.launches(), "k3": 0}
    family = get_arch(cell.arch_id).family
    if not on_gpu:
        return out
    if family == "gnn" and cell.args[1]["edge_src"].dtype == torch.uint8:
        out["k1"] = 2
    elif cell.kind in ("prefill", "decode"):
        out["k3"] = cell.cfg.n_layers
    return out


def kernel_counts() -> dict:
    return {"k1": compbin_decode.launches, "k2": segment_sum.launches,
            "k2_grad": segment_sum.grad_launches,
            "k3": flash_attention.launches}


def _count_delta(before: dict) -> dict:
    now = kernel_counts()
    return {k: now[k] - before[k] for k in now}


def check_cell_outputs(out, want: list, what: str) -> None:
    """Every output's shape and dtype equal the abstract trace's
    (``want``, as ``dryrun.leaf_shapes`` lists them): the dry run's own
    contract."""
    from repro_torch.launch.dryrun import leaf_shapes
    got = leaf_shapes(out)
    assert got == want, \
        f"{what}: outputs {got} != the abstract trace's {want}"


def _cell_kernel_class(name: str) -> str:
    if "compbin" in name or "k1_" in name:
        return "k1"
    return _train_kernel_class(name)


def profile_cell_step(work, device) -> dict:
    """``work()`` once under ``torch.profiler`` (shapes recorded): device
    ms by kernel class (K1, K2, K2's backward, K3, GEMMs, copies,
    other), the host-clock wall, the top kernels, and the collectives
    :func:`collectives_from_profile` reads (a world of one: none)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.hlo_analysis import collectives_from_profile

    on_gpu = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_gpu
                                     else [])
    _cuda_sync(device)
    with profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        work()
        _cuda_sync(device)
        wall = time.perf_counter() - t0
    classes = ("k1", "k2", "k2_grad", "k3", "gemm", "copy", "other")
    sums, kernels = dict.fromkeys(classes, 0.0), []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us:
            sums[_cell_kernel_class(ev.key)] += us / 1e3
            kernels.append((us / 1e3, ev.count, ev.key[:60]))
    coll = collectives_from_profile(prof, 1)
    busy = sum(sums.values())
    return {"wall_ms": wall * 1e3, "device_ms": sums if busy else None,
            "idle_share": 1 - busy / (wall * 1e3) if busy else None,
            "top_kernels": sorted(kernels, reverse=True)[:6],
            "collectives": {"ops": coll.ops, "wire_bytes": coll.wire_bytes}}


def shadow_attend(checks: list, n_rows: int = CELL_SHADOW_ROWS,
                  seed: int = 0):
    """A serving attention for a cell's ``attend=``: the port's
    ``attention``, with ``n_rows`` sampled query rows of each call's
    output held to :func:`attention_f64` on those rows (a full float64
    check of a 32k prefill would need terabytes): within ``K3_TOL`` of
    the output's dtype, atol scaled by max(1, max|v|); per call
    ``checks`` gets the worst error over its atol."""
    from repro_torch.models import transformer as tf

    rng = np.random.default_rng(seed)

    def checked(q, k, v, cfg, *, causal, q_offset=0):
        out = tf.attention(q, k, v, cfg, causal=causal, q_offset=q_offset)
        b, s = q.shape[:2]
        tol = K3_TOL.get(q.dtype, K3_TOL[torch.float32])
        worst = 0.0
        for _ in range(n_rows):
            bi, si = int(rng.integers(b)), int(rng.integers(s))
            want = attention_f64(q[bi:bi + 1, si:si + 1], k[bi:bi + 1],
                                 v[bi:bi + 1], q_offset + si)
            got = out[bi:bi + 1, si:si + 1].double()
            live = v[bi:bi + 1, :q_offset + si + 1]
            atol = tol * max(1.0, float(live.abs().max()))
            err = float((got - want).abs().max())
            assert err <= atol + tol * float(want.abs().max()), \
                (f"attention row ({bi}, {si}) of a [{b}, {s}] call: max "
                 f"abs err {err} beyond rtol {tol}, atol {atol}")
            worst = max(worst, err / atol)
        checks.append(worst)
        return out

    return checked


def _cell_loss(cell, packed: bool = True):
    """The loss a GNN cell's step differentiates, as a function of
    (params, batch); with ``packed`` False, the same loss on a batch
    whose edge ids are int64 (no decode)."""
    import functools

    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.core.compbin import bytes_per_vertex
    from repro_torch.launch import steps
    shp = GNN_SHAPES[cell.shape_id]
    cb_b = bytes_per_vertex(shp.n_nodes) \
        if packed and cell.args[1]["edge_src"].dtype == torch.uint8 else 0
    return functools.partial(steps._gnn_loss,
                             mod=steps._GNN_MODULES[cell.arch_id],
                             cfg=cell.cfg, static={"n_graphs": shp.n_graphs},
                             cb_b=cb_b)


def cell_parity(cell, params, batch, device, edge_ids=None) -> dict:
    """A GNN cell's first step on the card held to the plain path: for
    GCN by :func:`first_step_parity` (K2's launches as asked, the loss
    within ``TRAIN_LOSS_RTOL``, the gradients within ``TRAIN_GRAD_TOL``,
    as ``[train]`` holds them), for PNA, MeshGraphNet and DimeNet by
    :func:`first_step_pair` with both paths' gradients within
    :data:`CELL_GRAD_SHARE` of the float64 plain path's; and its loss to
    the plain CPU path on the same weights and inputs.  A packed cell's
    plain path is fed ``edge_ids``, the int64 ids packed (no decode)."""
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.launch import steps

    loss = _cell_loss(cell)
    plain_fn = None
    if edge_ids is not None:
        unpacked, plain = dict(batch, **edge_ids), _cell_loss(cell, False)

        def plain_fn(p):
            return plain(p, unpacked)
    if cell.arch_id == "gcn-cora":
        par = first_step_parity(lambda p: loss(p, batch), params,
                                plain_fn=plain_fn)
    else:
        par, grads_k, grads_p = first_step_pair(lambda p: loss(p, batch),
                                                params, plain_fn)
        full = dict(batch, n_graphs=GNN_SHAPES[cell.shape_id].n_graphs)
        grads_x = exact_plain_grads(steps._GNN_MODULES[cell.arch_id],
                                    cell.cfg, full, params)()
        got = par["kernel_relative_distance"] = relative_distance(grads_k,
                                                                  grads_x)
        scale = par["plain_relative_distance"] = relative_distance(grads_p,
                                                                   grads_x)
        assert got <= CELL_GRAD_SHARE and scale <= CELL_GRAD_SHARE, \
            (f"first-step grads {got} (kernel path) / {scale} (plain) of "
             f"max|g| from float64, beyond {CELL_GRAD_SHARE}")
    with torch.no_grad():
        cpu_loss = float(loss(to_cpu(params), to_cpu(batch)))
    par["cpu_loss"] = cpu_loss
    par["cpu_loss_rel_err"] = abs(par["loss"] - cpu_loss) / abs(cpu_loss)
    assert par["cpu_loss_rel_err"] <= TRAIN_LOSS_RTOL, \
        f"card loss {par['loss']} != the plain CPU path's {cpu_loss}"
    return par


def check_packed_ids(batch: dict, edge_ids: dict, b: int) -> int:
    """The edge ids a packed cell's step decodes
    (``steps.decode_packed_edges``: K1, the pad id mapped to -1) equal
    the ids packed, as int64; returns how many were checked."""
    from repro_torch.launch.steps import decode_packed_edges

    got = decode_packed_edges(batch, b)
    for key, want in edge_ids.items():
        assert torch.equal(got[key].long(), want), \
            f"{key}: ids K1 decoded differ from decode_ids"
    return sum(want.numel() for want in edge_ids.values())


def run_cell_on_device(cell, rec: dict, device, *, reps: int = CELL_STEP_REPS,
                       parity: bool = False, lm_shape=None,
                       seed: int = 0) -> dict:
    """One cell run on ``device`` at its catalog shapes (``lm_shape``
    cuts an LM batch for a rehearsal): weights from its ``init_params``,
    inputs from :func:`cell_batch`.

    Train cells: (a packed cell's decoded ids by
    :func:`check_packed_ids`, then with ``parity`` :func:`cell_parity`
    first), a warm-up step whose outputs match the abstract trace's,
    ``reps`` timed steps (median), one profiled step.  Serving cells: a
    warm-up call with its outputs checked (a prefill's attention rows
    held to float64 through :func:`shadow_attend`), then one timed call under the profiler (a
    32k-token prefill takes seconds) or ``reps`` timed calls and a
    profiled one.  Every call's launches must equal
    :func:`cell_expected` of its requests (the first call's kept as
    ``expected_per_step``); every loss and output is finite.  Returns the
    step ms, ``max_memory_allocated`` over the cell's own allocations
    beside the estimate, the TFLOP/s of ``model_flops``, the profiler
    split, the launches on the main path and those made by checks."""
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    on_gpu = torch.device(device).type == "cuda"
    label = f"{cell.arch_id}|{cell.shape_id}|{rec.get('variant')}"
    base = torch.cuda.memory_allocated(device) if on_gpu else 0
    t_start = time.perf_counter()
    main = dict.fromkeys(kernel_counts(), 0)
    checks_made = dict.fromkeys(kernel_counts(), 0)
    out = {"arch": cell.arch_id, "shape": cell.shape_id,
           "variant": rec.get("variant", "baseline"), "kind": cell.kind,
           "estimate_bytes": rec["memory"]["card_peak_est_bytes"]}
    params = cell_params(cell, device, seed)
    batch, edge_ids = cell_batch(cell, device, seed + 1, lm_shape)
    want_out = rec["outputs"]
    if lm_shape is not None and cell.kind != "train":
        # a rehearsal's smaller LM batch: trace it again
        from repro_torch.launch.dryrun import leaf_shapes
        from repro_torch.launch.steps import _abstract, to_meta
        want_out = leaf_shapes(_abstract(cell.fn, to_meta(params),
                                         to_meta(batch)))

    def step_call(state, **kw):
        c0 = kernel_counts()
        with kernel_requests() as asked:
            res = cell.fn(state, batch, **kw)
        _cuda_sync(device)
        got, expected = _count_delta(c0), cell_expected(cell, asked, on_gpu)
        assert got == expected, f"{label}: launches {got} != {expected}"
        out.setdefault("expected_per_step", expected)
        for k in main:
            main[k] += got[k]
        return res

    if cell.kind == "train":
        c0 = kernel_counts()
        if edge_ids is not None:
            b = batch["edge_src"].numel() // edge_ids["edge_src"].numel()
            out["ids_checked"] = check_packed_ids(batch, edge_ids, b)
        if parity:
            out["parity"] = cell_parity(cell, params, batch, device,
                                        edge_ids)
        for k, v in _count_delta(c0).items():
            checks_made[k] += v
        if on_gpu:              # the checks' own memory is not the step's
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        state = {"params": params, "opt": adamw_init(params, AdamWConfig())}
        del params
        res = step_call(state)
        check_cell_outputs(res, want_out, label)
        state, met = res
        del res
        losses, secs = [float(met["loss"])], []
        for _ in range(reps):
            t0 = time.perf_counter()
            state, met = step_call(state)
            secs.append(time.perf_counter() - t0)
            losses.append(float(met["loss"]))
        assert np.isfinite(losses).all(), f"{label}: losses {losses}"
        out["losses"] = losses
        out["step_ms"] = statistics.median(secs) * 1e3
        out["steps_ms"] = [t * 1e3 for t in secs]
        out["profile"] = profile_cell_step(lambda: step_call(state), device)
        del state, met
    else:
        if on_gpu:
            torch.cuda.reset_peak_memory_stats(device)
        shadow = []
        res = step_call(params, **({"attend": shadow_attend(shadow)}
                                   if cell.kind == "prefill" else {}))
        check_cell_outputs(res, want_out, label)
        finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(res)
                     if t.is_floating_point())
        assert finite, f"{label}: non-finite outputs"
        del res
        if shadow:
            out["shadow_calls"] = len(shadow)
            out["shadow_worst_err_over_atol"] = max(shadow)
        if cell.kind == "prefill":
            prof = profile_cell_step(lambda: step_call(params), device)
            out["profile"] = prof
            out["step_ms"] = prof["wall_ms"]
            out["steps_ms"] = [prof["wall_ms"]]
        else:
            secs = []
            for _ in range(reps):
                t0 = time.perf_counter()
                step_call(params)
                secs.append(time.perf_counter() - t0)
            out["step_ms"] = statistics.median(secs) * 1e3
            out["steps_ms"] = [t * 1e3 for t in secs]
            out["profile"] = profile_cell_step(lambda: step_call(params),
                                               device)
    assert not out["profile"]["collectives"]["ops"], \
        f"{label}: collectives on a world of one: {out['profile']}"
    if on_gpu:
        out["max_memory_allocated"] = \
            torch.cuda.max_memory_allocated(device) - base
        out["estimate_over_measured"] = (out["estimate_bytes"]
                                         / max(1, out["max_memory_allocated"]))
    out["tflop_per_s"] = cell.model_flops / (out["step_ms"] * 1e-3) / 1e12
    out["model_flops"] = cell.model_flops
    out["main_launches"] = main
    out["check_launches"] = checks_made
    out["wall_s"] = time.perf_counter() - t_start
    del batch, edge_ids
    return out


def phase_cells(device, *, jobs: int | None = None, cells=None,
                expect: dict | None = CELL_STATUS, free_bytes=None,
                reps: int = CELL_STEP_REPS, lm_shape=None) -> dict:
    """``[cells]``: every cell of ``cells`` (default: the 40 baseline
    cells and :data:`CELL_VARIANTS`) dry-run on the card mesh
    (``dryrun.run_cells``, ``jobs`` processes; :func:`check_dry_run`),
    then one step of every cell whose card-path peak estimate fits in
    :data:`CELLS_MEM_SHARE` of the device's free memory
    (``free_bytes`` where the device is no card) run by
    :func:`run_cell_on_device` at its catalog shapes, the baseline GNN
    cells on :data:`CELL_PARITY_SHAPES` and the ``edges_compbin`` cells
    with their parity checks.  A cell
    not run is logged with its estimate."""
    from repro_torch.launch.dryrun import run_cells
    from repro_torch.launch.mesh import card_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.launch.variants import apply_variant

    t0 = time.perf_counter()
    on_gpu = torch.device(device).type == "cuda"
    jobs = jobs or max(1, min(8, os.cpu_count() or 1))
    cells = cells or all_cell_jobs()
    recs = run_cells(cells, "card", jobs)
    dry_s = time.perf_counter() - t0
    counts = check_dry_run(recs, expect, cells)
    log(f"[cells] dry run of {len(recs)} cells on the card mesh in "
        f"{dry_s:.1f} s on {jobs} processes: " + ", ".join(
            f"{k} {v}" for k, v in counts.items()))
    runs, not_run = [], []
    for job, rec in zip(cells, recs):
        if rec["status"] != "OK":
            continue
        gc.collect()
        if on_gpu:
            torch.cuda.empty_cache()
            free = torch.cuda.mem_get_info(device)[0]
        else:
            free = free_bytes
        est = rec["memory"]["card_peak_est_bytes"]
        if est > CELLS_MEM_SHARE * free:
            not_run.append({"arch": rec["arch"], "shape": rec["shape"],
                            "variant": rec["variant"], "estimate_bytes": est,
                            "free_bytes": free})
            continue
        kw = {**apply_variant(job[0], job[1], job[2]),
              **(job[3] if len(job) > 3 else {})}
        cell = build_cell(job[0], job[1], card_mesh(), **kw)
        parity = rec["family"] == "gnn" and (
            job[1] in CELL_PARITY_SHAPES if job[2] == "baseline"
            else job[2] == "edges_compbin")
        r = run_cell_on_device(cell, rec, device, reps=reps, parity=parity,
                               lm_shape=lm_shape)
        r["free_bytes"] = free
        runs.append(r)
        log_cell_run(r)
        del cell
    main = {k: sum(r["main_launches"][k] for r in runs)
            for k in ("k1", "k2", "k2_grad", "k3")}
    checks = {k: sum(r["check_launches"][k] for r in runs) for k in main}
    return {"records": recs, "counts": counts, "dry_run_s": dry_s,
            "jobs": jobs, "runs": runs, "not_run": not_run,
            "main_launches": main, "check_launches": checks,
            "wall_s": time.perf_counter() - t0}


def log_cell_record(r: dict) -> None:
    if r["status"] != "OK":
        log(f"[cells] dry run {r['arch']}|{r['shape']}|{r['variant']}: "
            f"{r['status']} {r.get('skip_reason', r.get('error', ''))[:80]}")
        return
    m, c, rl = r["memory"], r["cost"], r["roofline"]
    log(f"[cells] dry run {r['arch']}|{r['shape']}|{r['variant']} "
        f"({r['kind']}): {c['flops']:.4g} FLOP counted ({c['matmul_flops']:.4g}"
        f" in products), {c['bytes_accessed']:.4g} B accessed, peak estimate "
        f"{m['peak_est_bytes']:.4g} B (card path {m['card_peak_est_bytes']:.4g}"
        f" B); roofline compute {rl['t_compute']:.4g} s at "
        f"{rl['peak_flops'] / 1e12:.0f} TFLOP/s ({rl['compute_dtype']}), memory "
        f"{rl['t_memory']:.4g} s, collective {rl['t_collective']:.4g} s, "
        f"dominant {rl['dominant']}; useful_ratio {rl['useful_ratio']:.4f}"
        + (f", arithmetic ratio {r['arith_ratio']:.4f}"
           if "arith_ratio" in r else "")
        + f"; trace {r['trace_s']:.1f} s")


def log_cell_run(r: dict) -> None:
    sp = r["profile"]
    mem = (f"max_memory_allocated {r['max_memory_allocated']} B vs estimate "
           f"{r['estimate_bytes']} B (estimate / measured "
           f"{r['estimate_over_measured']:.3f})"
           if "max_memory_allocated" in r else
           f"estimate {r['estimate_bytes']} B")
    extra = ""
    if "parity" in r:
        p = r["parity"]
        extra += (f"; first step vs plain"
                  + (" (fed the int64 ids)" if "ids_checked" in r else "")
                  + f": loss rel err "
                  f"{p['loss_rel_err']:.3g}, vs the CPU "
                  f"{p['cpu_loss_rel_err']:.3g}"
                  + (f", grads from float64 {p['kernel_relative_distance']:.3g}"
                     f" (plain {p['plain_relative_distance']:.3g}) of max|g|"
                     if "kernel_relative_distance" in p else
                     f", grads max abs err "
                     f"{max(p['grad_max_abs_err'].values()):.3g}"))
    if "ids_checked" in r:
        extra += f"; {r['ids_checked']} ids K1 decoded equal decode_ids"
    if "shadow_calls" in r:
        extra += (f"; {r['shadow_calls']} K3 calls x {CELL_SHADOW_ROWS} rows "
                  f"held to float64, worst err / atol "
                  f"{r['shadow_worst_err_over_atol']:.3g}")
    log(f"[cells] ran {r['arch']}|{r['shape']}|{r['variant']} ({r['kind']}): "
        f"step {r['step_ms']:.3f} ms (" + ", ".join(
            f"{t:.1f}" for t in r["steps_ms"]) + f"), {r['tflop_per_s']:.3f} "
        f"TFLOP/s of model FLOPs; {mem}; launches a step "
        + ", ".join(f"{k} {v}" for k, v in r["expected_per_step"].items())
        + extra + "; device ms by class: "
        + ("not measured" if not sp["device_ms"] else ", ".join(
            f"{k} {v:.3f}" for k, v in sp["device_ms"].items() if v)
           + f"; idle share {sp['idle_share']:.3f}")
        + f"; collectives {sp['collectives']['ops'] or 0}; "
        f"wall {r['wall_s']:.1f} s")


#: the edge ids of the GNN cells and of K2's timings at their shapes
#: (:func:`cell_batch`): no degree law is claimed for them
CELL_IDS = "uniform over the real nodes (Erdos-Renyi), -1 in the pads"
#: ogbn-products' padded full-graph shapes: [E, 16] messages into [N, 16]
OGB_E, OGB_N, OGB_REAL = 61_859_328, 2_449_152, (61_859_140, 2_449_029)
#: K1's shapes in the two ``edges_compbin`` cells: (ids, b)
K1_CELL_SHAPES = {"full_graph_sm": (10_752, 2), "minibatch_lg": (168_960, 3)}
#: K3 at one sequence of the 32k prefill: q [1, 15, 32768, 64]
K3_CELL_SHAPE = dict(b=1, hq=15, hkv=5, s=32768, dh=64)
#: K3's shapes whose CUDA launches a call are counted in a fresh process
#: (:func:`fresh_k2_launches`)
K3_FRESH_SHAPES = {**MOE_K3_SHAPES,
                   "cells_prefill": dict(dtype=torch.bfloat16,
                                         **K3_CELL_SHAPE)}


def measure_k3_long(flush, gen, workdir: str, rows: int = 8) -> dict:
    """K3 ``tc_prefill`` at bf16 q[1,15,32768,64] over k/v[1,5,32768,64],
    causal: ``rows`` sampled query rows held to :func:`attention_f64`
    (the plain version's [S, S] scores are 4 GB a head: it is not run),
    the kernel's and SDPA ``is_causal``'s CUDA-event times, the bound and
    the CUDA launches of a call (in a fresh process: late in a run the
    profiler lost one call's kernel of eight here)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sh = K3_CELL_SHAPE
    b, hq, hkv, s, dh = sh["b"], sh["hq"], sh["hkv"], sh["s"], sh["dh"]
    q, k, v = _k3_inputs(b, hq, hkv, s, s, dh, torch.bfloat16, gen)

    def kernel():
        return flash_attention(q, k, v)

    got = kernel()
    lib = sdpa(q, k, v, is_causal=True, enable_gqa=True)
    rng = np.random.default_rng(3)
    tol = K3_TOL[torch.bfloat16]
    worst, worst_lib = 0.0, 0.0
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    atol = tol * max(1.0, float(v.abs().max()))
    for r in rng.integers(0, s, rows):
        r = int(r)
        want = attention_f64(qs[:, r:r + 1], ks, vs, r)[:, 0]
        err = float((got[:, :, r].double() - want).abs().max())
        worst_lib = max(worst_lib, float(
            (lib[:, :, r].double() - want).abs().max()))
        assert err <= atol + tol * float(want.abs().max()), \
            f"K3 at 32k, row {r}: max abs err {err} beyond {atol}"
        worst = max(worst, err)
    del got, lib
    counted = fresh_k2_launches({}, workdir, ("cells_prefill",)) \
        .get("cells_prefill")
    ms = time_cuda(kernel, flush=flush, reps=10, warmup=2)
    lib_ms = time_cuda(lambda: sdpa(q, k, v, is_causal=True,
                                    enable_gqa=True), flush=flush)
    nbytes, flops = k3_work(b, hq, hkv, s, dh, s, 0)
    bms, by = k3_bound_ms(nbytes, flops)
    design = plan(torch.bfloat16, hq // hkv * s, s, dh, b * hkv)[0]
    return {"design": design, "dtype": "bfloat16", "b": b, "hq": hq,
            "hkv": hkv, "sq": s, "kv_len": s, "dh": dh,
            "rows_checked": rows, "max_abs_err": worst,
            "library_max_abs_err": worst_lib, "ms": ms,
            "plain_ms": "not run", "library_ms": lib_ms,
            "library_call": "sdpa_is_causal", "bound_ms": bms,
            "bound_by": by, "bytes": nbytes, "flops": flops,
            "tflop_per_s": flops / (ms * 1e-3) / 1e12,
            "cuda_launches_per_call": counted and counted[0]}


def measure_cells_kernels(workdir: str) -> dict:
    """K2 and its backward at ogbn-products' full-graph shapes (uniform
    ids over the real nodes, -1 in the padded edge slots), K1 at the two
    ``edges_compbin`` cells' shapes and K3 at the 32k prefill's, each
    beside its bound, plain version and library call."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    flush = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
    ids = _ids(OGB_REAL[0], OGB_E, OGB_REAL[1], gen, "cuda").to(torch.int32)
    k2 = measure_segment_sum_full_graph(ids, OGB_N, (16,), flush,
                                        gen)["widths"][16]
    k2g = measure_segment_sum_grad(ids, 16, OGB_N, flush, gen)
    del ids
    torch.cuda.empty_cache()
    k1 = {label: measure_kernel(random_packed(n, b, gen), b, flush)
          for label, (n, b) in K1_CELL_SHAPES.items()}
    k3 = measure_k3_long(flush, gen, workdir)
    del flush
    torch.cuda.empty_cache()
    return {"k2": k2, "k2_grad": k2g, "k1": k1, "k3": k3}


def cells_slice(device, workdir: str) -> dict:
    """``main``'s ``[cells]`` phase, also run alone to rehearse it: every
    count zeroed just before :func:`phase_cells` and read just after
    (the checks' launches taken off), then the kernels timed at the new
    shapes (:func:`measure_cells_kernels`)."""
    gc.collect()
    # cuBLAS's workspaces (2 x 32 MiB) sit in segments the earlier phases'
    # tensors left, and a segment with one live block cannot be returned:
    # 22.8 GB stayed reserved with 67.6 MB allocated (NVIDIA H100 80GB
    # HBM3, 700.00 W) until they were freed
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(device)
    live = sorted(((o.numel() * o.element_size(), tuple(o.shape), str(o.dtype))
                   for o in gc.get_objects() if isinstance(o, torch.Tensor)
                   and o.is_cuda), reverse=True)
    log(f"[cells] card memory before the phase: {free} B free of {total}, "
        f"{torch.cuda.memory_allocated(device)} B allocated, "
        f"{torch.cuda.memory_reserved(device)} B reserved; largest live "
        f"CUDA tensors: {live[:6]}")
    compbin_decode.launches = segment_sum.launches = 0
    segment_sum.grad_launches = flash_attention.launches = 0
    r = phase_cells(device)
    got = kernel_counts()
    main = {k: got[k] - r["check_launches"][k] for k in got}
    assert main == r["main_launches"], (main, r["main_launches"])
    ran = {(x["arch"], x["shape"], x["variant"]) for x in r["runs"]}
    for name, key in (("k1", ("gcn-cora", "full_graph_sm", "edges_compbin")),
                      ("k2", ("gcn-cora", "full_graph_sm", "baseline")),
                      ("k3", ("smollm-360m", "prefill_32k", "baseline"))):
        assert key in ran and main[name] > 0, (name, key, main)
    for rec in r["records"]:
        log_cell_record(rec)
    for x in r["not_run"]:
        log(f"[cells] not run {x['arch']}|{x['shape']}|{x['variant']}: card-"
            f"path peak estimate {x['estimate_bytes']} B > "
            f"{CELLS_MEM_SHARE} x {x['free_bytes']} B free")
    log(f"[cells] dry run of {len(r['records'])} cells in {r['dry_run_s']:.1f}"
        f" s on {r['jobs']} processes: " + ", ".join(
            f"{k} {v}" for k, v in r["counts"].items())
        + f" of the 40 baseline cells; {len(r['runs'])} cells run on the "
        f"card, {len(r['not_run'])} not run; main-path launches "
        + ", ".join(f"{k} {v}" for k, v in main.items())
        + f"; phase wall {r['wall_s']:.1f} s")
    t0 = time.perf_counter()
    kern = measure_cells_kernels(workdir)
    k2, k2g, k3 = kern["k2"], kern["k2_grad"], kern["k3"]
    log(f"[kernel] segment_sum at ogbn-products' size, uniform ids: "
        f"f32[{k2['e']},16] by int32[{k2['e']}] ({k2['valid_edges']} valid) "
        f"-> f32[{k2['n']},16]: "
        f"plan picks {k2['design']} {k2['ms']:.4f} ms (" + ", ".join(
            f"{m} {v['ms']:.4f}" for m, v in k2["designs"].items())
        + f"); bound {k2['bound_ms']:.4f} ms ({k2['bound_by']}); plain "
        f"{k2['plain_ms']:.4f} ms; index_add_ {k2['library_ms']:.4f} ms")
    log(f"[kernel] segment_sum backward at ogbn-products' size, uniform "
        f"ids: {k2g['ms']:.4f} ms "
        f"at VEC {k2g['vec']}; bound {k2g['bound_ms']:.4f} ms; plain "
        f"{k2g['plain_ms']:.4f} ms; library {k2g['library_ms']:.4f} ms "
        f"({k2g['library_call']})")
    for label, k1 in kern["k1"].items():
        log(f"[kernel] compbin_decode at the {label} edges_compbin shape "
            f"b={k1['b']} n={k1['n']}: {k1['ms']:.4f} ms; bound "
            f"{k1['bound_ms']:.4f} ms ({k1['bound_by']}); plain "
            f"{k1['plain_ms']:.4f} ms; library "
            + ("none" if k1["library_ms"] is None
               else f"{k1['library_ms']:.4f} ms"))
    log(f"[kernel] flash_attention {k3['design']} bf16 q[1,15,32768,64] over "
        f"k/v[1,5,32768,64] causal: {k3['ms']:.4f} ms ({k3['tflop_per_s']:.1f}"
        f" TFLOP/s, CUDA launches per call {k3['cuda_launches_per_call']}); "
        f"bound {k3['bound_ms']:.4f} ms ({k3['bound_by']}); plain not run "
        f"(its [S, S] scores); SDPA is_causal {k3['library_ms']:.4f} ms; "
        f"{k3['rows_checked']} rows held to float64 (max abs err "
        f"{k3['max_abs_err']:.3g}, SDPA's {k3['library_max_abs_err']:.3g})")
    r["kernels"] = kern
    r["kernels_s"] = time.perf_counter() - t0
    r["main_launches"] = main
    return r


def cells_kernel_entry(r: dict, name: str) -> dict:
    """The ``cells`` entry of kernel ``name``'s item in the kernels line:
    its shapes in this phase with their launches and times."""
    kern, main = r["kernels"], r["main_launches"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    if name == "compbin_decode":
        return {label: {"shape": f"uint8[{k['n']}*{k['b']}] -> "
                                 f"int32[{k['n']}]", **{x: k[x] for x in keys}}
                for label, k in kern["k1"].items()} | {"launches": main["k1"]}
    if name == "segment_sum":
        k = kern["k2"]
        return {"ogb_products": {"shape": f"f32[{k['e']},16] by "
                                          f"int32[{k['e']}] -> "
                                          f"f32[{k['n']},16]",
                                 "ids": CELL_IDS, "design": k["design"],
                                 **{x: k[x] for x in keys}},
                "launches": main["k2"]}
    if name == "segment_sum_backward":
        k = kern["k2_grad"]
        return {"ogb_products": {"shape": f"f32[{k['n']},16] by "
                                          f"int32[{k['e']}] -> "
                                          f"f32[{k['e']},16]",
                                 "ids": CELL_IDS, "vec": k["vec"],
                                 **{x: k[x] for x in keys}},
                "launches": main["k2_grad"]}
    k = kern["k3"]
    return {"prefill_32k": {"shape": "bf16 q[1,15,32768,64] k/v[1,5,32768,64]"
                                     " causal", "design": k["design"],
                            **{x: k[x] for x in keys}},
            "launches": main["k3"]}


# ---------------------------------------------------------------------------
# [examples]: the four examples of examples/*_torch.py, run in process
# ---------------------------------------------------------------------------

def no_launches(args, r: dict, first: dict) -> dict:
    """An example whose path runs no kernel on the card."""
    return {}


def quickstart_launches(args, r: dict, first: dict) -> dict:
    """K1 once a streamed partition."""
    return {"k1": r["stream"]["partitions"]}


def gnn_launches(args, r: dict, first: dict) -> dict:
    """K1 once a streamed partition of the hosts or a device batch of the
    query engine (``--sampled``)."""
    return {"k1": (r["engine"]["device_batches"] if args.sampled
                   else sum(h["partitions"] for h in r["hosts"]))}


def example_launches(run: "ExampleRun", args, r: dict, first: dict,
                     on_gpu: bool, asked: KernelRequests) -> dict:
    """The kernel launches ``run`` makes: K2 and its backward as the run's
    requests ``asked`` (:func:`kernel_requests`), K1 on the card as its
    ``launches`` reckons it, K3 never (training takes the plain
    attention); none on the CPU."""
    want = {"k1": 0, **asked.launches(), "k3": 0}
    if on_gpu:
        want.update(run.launches(args, r, first))
    return want


def check_example_launches(label: str, got: dict, want: dict) -> None:
    """The kernels launched in an example's run as ``want`` reckons them
    (:func:`example_launches`), and on the card every kernel that run's
    path holds launched."""
    assert got == want, f"{label}: kernel launches {got}, expected {want}"


def check_losses_fall(label: str, losses: list, window: int) -> dict:
    """Every loss finite and the mean of the last ``window`` below that of
    the first ``window``; returns both means."""
    first = float(np.mean(losses[:window]))
    last = float(np.mean(losses[-window:]))
    assert len(losses) >= window and np.isfinite(losses).all(), \
        f"{label}: {len(losses)} losses, not all finite: {losses}"
    assert last < first, (f"{label}: the loss does not fall: mean of the "
                          f"first {window} {first}, of the last {last}")
    return {"first_mean": first, "last_mean": last}


def check_lm_learns(losses: list, vocab: int, window: int) -> dict:
    """The LM example's printed claim: the mean of the last ``window``
    losses below that of the first and below ln(vocab), the unigram
    entropy of a uniform draw."""
    r = check_losses_fall("lm", losses, window)
    assert r["last_mean"] < math.log(vocab), \
        (f"lm: mean of the last {window} losses {r['last_mean']} not below "
         f"ln(vocab) {math.log(vocab)}")
    return {**r, "ln_vocab": math.log(vocab)}


def check_first_loss(label: str, loss: float, plain: float) -> float:
    """The loss an example printed for its first step within
    ``TRAIN_LOSS_RTOL`` of ``plain`` (the plain path's, or float64's, on
    the same params and batch); returns the relative error."""
    err = abs(loss - plain) / abs(plain)
    assert err <= TRAIN_LOSS_RTOL, \
        f"{label}: first-step loss {loss} != the reference's {plain}"
    return err


def gnn_checks(label: str, args, r: dict, first: dict, device) -> dict:
    """The first step on the kernel path against the plain path on the
    same device (:func:`first_step_parity`, as ``[train]`` holds its
    own) with the first loss the example printed held to it; the losses
    falling over 10 steps."""
    from repro_torch.models.gnn import gcn

    params, batch, cfg = first["args"]
    par = first_step_parity(lambda p: gcn.loss_fn(p, batch, cfg), params)
    par["printed_loss_rel_err"] = check_first_loss(
        label, r["losses"][0], par["plain_loss"])
    return {"parity": par, **check_losses_fall(label, r["losses"], 10),
            "k2_case": (batch["edge_dst"], int(batch["x"].shape[0]),
                        cfg.d_hidden)}


def din_checks(label: str, args, r: dict, first: dict, device) -> dict:
    """The first request's scores within ``DIN_TOL`` of the plain CPU
    path, as ``[din]`` holds them."""
    from repro_torch.models.recsys import din

    params, batch, cfg = first["args"]
    with torch.inference_mode():
        want = din.forward(to_cpu(params), to_cpu(batch), cfg)
    return {"max_abs_err": din_close(torch.from_numpy(r["scores"][0]),
                                     want, f"{label} request 0"),
            "rows_checked": int(want.numel())}


#: the LM's first-step gradients in f32 against float64 on the same
#: params and batch: each within this share of its max|g|.  The f32
#: rounding of lm-100m's first step at its true fan-in lies at 1.1e-6 to
#: 2.0e-6 x max|g| on the CPU (2 and 4 layers); TF32 products would
#: put it near 1e-3
LM_F64_GRAD_SHARE = 1e-4


def fan_in_params(mod, args, device):
    """The LM example's weights as its ``run`` draws them (the port's
    ``init_params``, seed 0), the attention projections then scaled to
    the fan-in each has: wq, wk and wv to std d^-1/2, wo to (H dh)^-1/2.
    ``init_params`` takes a 4-D weight's second-to-last axis as its
    fan-in, as the JAX package's ``dense_init`` does: H, Hk and dh
    (:func:`attention_saturation`)."""
    cfg = mod.model_config(args)
    params = mod.tf.init_params(
        cfg, torch.Generator(device=device).manual_seed(0))
    lay, d = params["layers"], cfg.d_model
    for name, drawn in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                        ("wv", cfg.n_kv_heads)):
        lay[name] = lay[name] * math.sqrt(drawn / d)
    lay["wo"] = lay["wo"] * math.sqrt(1 / cfg.n_heads)
    return params


def attention_saturation(params, tokens, cfg) -> dict:
    """How far from a spread softmax each layer's attention starts, on
    the first batch: the std of the causal scores q.k / sqrt(dh) and the
    mean of each query's largest weight, by layer (a serving forward
    with the plain attention, no grad)."""
    from repro_torch.models import transformer as tf

    std, top = [], []

    def attend(q, k, v, cfg, *, causal, q_offset=0):
        kk = k[:, :q_offset + q.shape[1]].float()
        kk = kk.repeat_interleave(q.shape[2] // kk.shape[2], dim=2)
        s = torch.einsum("bshd,bthd->bhst", q.float(), kk) \
            / math.sqrt(q.shape[-1])
        mask = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril(q_offset)
        std.append(float(s[..., mask].std()))
        top.append(float(s.masked_fill(~mask, -math.inf).softmax(-1)
                         .amax(-1).mean()))
        return tf.attention_plain(q, k, v, cfg, causal=causal,
                                  q_offset=q_offset)

    with torch.no_grad():
        tf.prefill(params, tokens, cfg, attend=attend)
    return {"score_std": std, "max_weight": top}


def lm_checks(label: str, args, r: dict, first: dict, device,
              asserted: bool) -> dict:
    """The LM example's run: every loss finite; the first step's loss
    and gradients in f32 against float64 on the same device, params and
    batch (the dense LM's training path runs no kernel, so a plain path
    would be the same code); how saturated the attention starts
    (:func:`attention_saturation`); the printed claim
    (:func:`check_lm_learns`).  ``asserted``: the first step within
    ``TRAIN_LOSS_RTOL`` / ``LM_F64_GRAD_SHARE`` of float64 and the claim
    held, else both reported."""
    from repro_torch.models import transformer as tf

    params, tokens, labels, cfg = first["args"]
    assert np.isfinite(r["losses"]).all(), \
        f"{label}: a non-finite loss in {r['losses']}"
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
    loss32, g32 = loss_and_grads(
        lambda p: tf.loss_fn(p, tokens, labels, cfg), params)
    loss64, g64 = loss_and_grads(
        lambda p: tf.loss_fn(p, tokens, labels, cfg64),
        tree_map(torch.Tensor.double, params))
    share = {k: float((g32[k].double() - g).abs().max() / g.abs().max())
             for k, g in g64.items() if g.numel() and g.abs().max()}
    out = {"f64": {"loss": loss32, "loss64": loss64,
                   "printed_loss_rel_err": abs(r["losses"][0] - loss64)
                   / abs(loss64), "grad_share": share},
           "attention": attention_saturation(params, tokens, cfg)}
    window = 20
    if not asserted:
        return {**out, "ln_vocab": math.log(r["vocab"]),
                "first_mean": float(np.mean(r["losses"][:window])),
                "last_mean": float(np.mean(r["losses"][-window:]))}
    check_first_loss(label, r["losses"][0], loss64)
    worst = max(share, key=share.get)
    assert share[worst] <= LM_F64_GRAD_SHARE, \
        (f"{label}: first-step grad {worst} {share[worst]:.3g} x max|g| "
         f"from float64, beyond {LM_F64_GRAD_SHARE}")
    return {**out, **check_lm_learns(r["losses"], r["vocab"], window)}


def quickstart_line(x: dict) -> str:
    st = x["stream"]
    loads = "; ".join(
        f"{fmt} {f['bytes_written']} B, direct "
        f"{f['direct']['s'] * 1e3:.1f} ms, PG-Fuse "
        f"{f['pgfuse']['s'] * 1e3:.1f} ms ({f['pgfuse']['underlying_reads']}"
        f" reads, {f['pgfuse']['hits']} hits)"
        for fmt, f in x["formats"].items())
    return (f"{x['vertices']} vertices, {x['edges']} edges; {loads}; "
            f"async {x['async']['partitions']} partitions, "
            f"{x['async']['edges']} edges; stream {st['partitions']} "
            f"partitions [{st['decode_mode']} decode], "
            f"{st['underlying_reads']} storage reads (+"
            f"{st['readahead_blocks']} readahead), {st['bytes_h2d']} B H2D, "
            f"{st['host_decode_bytes']} host-decoded bytes, "
            f"{st['decode_edges_per_s']:.4g} edges/s decode; streamed CSR "
            f"equal to the generated one")


def gnn_line(x: dict) -> str:
    c = x["checks"]
    p = c["parity"]
    where = ("engine " + ", ".join(
        f"{key} {x['engine'][key]}" for key in (
            "batches", "device_batches", "blocks_touched"))
        if "engine" in x else "hosts " + "; ".join(
            f"{h['partitions']} partitions {h['edges']} edges "
            f"{h['bytes_h2d']} B H2D" for h in x["hosts"]))
    return (f"{len(x['losses'])} steps, {x['steps_per_s']:.2f} steps/s; "
            f"{where}; loss mean first 10 {c['first_mean']:.4f} -> last 10 "
            f"{c['last_mean']:.4f}; first step: printed loss "
            f"{x['losses'][0]:.7f}, kernel path {p['loss']:.7f}, plain "
            f"{p['plain_loss']:.7f} (rel err {p['loss_rel_err']:.3g} <= "
            f"{TRAIN_LOSS_RTOL}), grads within rtol {TRAIN_GRAD_TOL[0]}, atol "
            f"{TRAIN_GRAD_TOL[1]} x max|g| (max abs err " + ", ".join(
                f"{name} {v:.3g}" for name, v in p["grad_max_abs_err"].items())
            + ")")


def din_line(x: dict) -> str:
    c = x["checks"]
    return (f"b = {x['b']}, p50 {x['p50_ms']:.3f} ms, p99 "
            f"{x['p99_ms']:.3f} ms (requests 3..), {x['wire_bytes']} wire "
            f"bytes; request 0's {c['rows_checked']} scores within {DIN_TOL} "
            f"of the plain CPU path (max abs err {c['max_abs_err']:.3g})")


def lm_line(x: dict, asserted: bool) -> str:
    c = x["checks"]
    f = c["f64"]
    a = c["attention"]
    tokens = x["args"]["batch"] * x["args"]["seq"]
    claim = "below" if c["last_mean"] < c["ln_vocab"] else "NOT below"
    how = "asserted" if asserted else "reported"
    return (f"{x['n_params']} parameters, {len(x['losses'])} steps of "
            f"{tokens} tokens, {x['tokens_per_s']:.1f} tokens/s "
            f"({x['tokens_per_s'] / tokens:.2f} steps/s); loss mean first 20 "
            f"{c['first_mean']:.4f} -> last 20 {c['last_mean']:.4f}, {claim} "
            f"ln(vocab) {c['ln_vocab']:.4f} ({how}); first step against "
            f"float64 ({how}): printed loss {x['losses'][0]:.7f}, f32 "
            f"{f['loss']:.7f}, float64 {f['loss64']:.7f} (printed rel err "
            f"{f['printed_loss_rel_err']:.3g}), grads at most "
            f"{max(f['grad_share'].values()):.3g} x max|g| from float64; "
            f"attention at the start: score std by layer "
            + ", ".join(f"{v:.3g}" for v in a["score_std"])
            + "; mean top weight " + ", ".join(f"{v:.3f}"
                                               for v in a["max_weight"])
            + f"; PG-Fuse {x['pgfuse']['underlying_reads']} underlying reads "
            f"/ {x['pgfuse']['cache_hits']} hits; {x['workdir_bytes']} B in "
            f"its workdir (the shard and its checkpoints)")


class ExampleRun(NamedTuple):
    """One run of ``[examples]``: ``example``, the file under
    ``examples/``, with command line ``argv`` (and ``params(mod, args,
    device)`` passed as ``run``'s ``params=``, else the example draws its
    own); ``recorded``, the library function (module, attribute) whose
    first call's arguments the checks take; ``launches(args, r, first)``,
    K1's launches in the run on the card (:func:`example_launches`);
    ``checks(label, args, r, first, device)``; ``line(x)``, its log
    line's middle part."""
    label: str
    example: str
    argv: tuple
    line: Callable
    launches: Callable = no_launches
    checks: Callable = lambda label, args, r, first, device: {}
    recorded: Optional[tuple] = None
    params: Optional[Callable] = None


_GNN = dict(example="train_gnn_from_compbin_torch.py", line=gnn_line,
            launches=gnn_launches, checks=gnn_checks,
            recorded=("repro_torch.models.gnn.gcn", "loss_fn"))
_LM = dict(example="train_lm_packed_tokens_torch.py",
           recorded=("repro_torch.models.transformer", "loss_fn"))

#: ``[examples]``' runs.  The quickstart at its default size, then the
#: paper's path at rmat(20, 16) (1,048,576 vertices, ~16.5 M edges
#: streamed into HBM through K1); the GNN example's two regimes at its
#: defaults (60 steps, 2 hosts); DIN over the 10M-item catalog its
#: docstring describes (3 bytes an id); lm-100m, 8 x 256 tokens a step,
#: f32, a checkpoint every 100 steps, as the example draws it (its
#: attention saturated from the first step: its printed claim is
#: reported), then from :func:`fan_in_params`, where the claim and the
#: first step against float64 are asserted.  100 steps each: the
#: schedule the example derives from ``--steps``
EXAMPLE_RUNS = (
    ExampleRun("quickstart", "quickstart_torch.py", ("--scale", "14"),
               quickstart_line, quickstart_launches),
    ExampleRun("quickstart_compbin", "quickstart_torch.py",
               ("--format", "compbin", "--scale", "20"), quickstart_line,
               quickstart_launches),
    ExampleRun("gnn", argv=(), **_GNN),
    ExampleRun("gnn_sampled", argv=("--sampled",), **_GNN),
    ExampleRun("din", "serve_din_requests_torch.py",
               ("--items", "10000000", "--requests", "20", "--batch", "64"),
               din_line, checks=din_checks,
               recorded=("repro_torch.models.recsys.din", "forward")),
    ExampleRun("lm", argv=("--steps", "100"),
               line=functools.partial(lm_line, asserted=False),
               checks=functools.partial(lm_checks, asserted=False), **_LM),
    ExampleRun("lm_fan_in", argv=("--steps", "100"),
               line=functools.partial(lm_line, asserted=True),
               checks=functools.partial(lm_checks, asserted=True),
               params=fan_in_params, **_LM),
)


def load_example(name: str):
    """``examples/<name>`` as a module: its ``build_parser`` and ``run``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name[:-3], os.path.join(_HERE, "examples", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def first_call(module, name: str, store: dict):
    """The arguments of the first call of ``module.<name>`` kept in
    ``store["args"]``, tensors detached (a step makes new params and
    leaves the ones it was given as they were)."""
    fn = getattr(module, name)

    def detached(x):
        if isinstance(x, dict):
            return {k: detached(v) for k, v in x.items()}
        return x.detach() if isinstance(x, torch.Tensor) else x

    def recording(*args):
        if "args" not in store:
            store["args"] = tuple(detached(a) for a in args)
        return fn(*args)

    setattr(module, name, recording)
    try:
        yield
    finally:
        setattr(module, name, fn)


def phase_examples(device, workdir: str, runs=EXAMPLE_RUNS) -> dict:
    """``[examples]``: each of ``runs`` (``EXAMPLE_RUNS``) through its
    example's ``run(args, device=)`` in this process, every kernel count
    zeroed just before and read just after and its requests to K2
    counted (held by :func:`check_example_launches`), the example's own
    checks raising
    where it asserts (the quickstart's streamed CSR against the generated
    one), then the run's ``checks``.  Returns each run's numbers, its
    wall time, its launches and its checks."""
    import importlib

    on_gpu = torch.device(device).type == "cuda"
    out = {}
    for run in runs:
        mod = load_example(run.example)
        args = mod.build_parser().parse_args(list(run.argv))
        if hasattr(args, "workdir"):
            args.workdir = os.path.join(workdir, "examples", run.label)
        kw = ({} if run.params is None
              else {"params": run.params(mod, args, device)})
        first = {}
        hook = (first_call(importlib.import_module(run.recorded[0]),
                           run.recorded[1], first)
                if run.recorded else contextlib.nullcontext())
        compbin_decode.launches = segment_sum.launches = 0
        segment_sum.grad_launches = flash_attention.launches = 0
        t0 = time.perf_counter()
        with hook, kernel_requests() as asked:
            r = mod.run(args, device=device, **kw)
        if on_gpu:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        launches = kernel_counts()
        check_example_launches(run.label, launches, example_launches(
            run, args, r, first, on_gpu, asked))
        t1 = time.perf_counter()
        checks = run.checks(run.label, args, r, first, device)
        out[run.label] = {"example": run.example, "argv": list(run.argv),
                          "args": vars(args), "wall_s": wall,
                          "launches": launches, "checks": checks,
                          "checks_s": time.perf_counter() - t1,
                          **{k: v for k, v in r.items() if k != "scores"}}
        if hasattr(args, "workdir"):
            out[run.label]["workdir_bytes"] = dir_bytes(args.workdir)
        del r, first, kw
        gc.collect()
        if on_gpu:
            torch.cuda.empty_cache()
    out_main = {k: sum(x["launches"][k] for x in out.values())
                for k in ("k1", "k2", "k2_grad", "k3")}
    return {"runs": out, "main_launches": out_main}


def log_example(run: ExampleRun, x: dict) -> None:
    """One line of ``[examples]`` for ``run``: what the example printed,
    its wall time, its launches and its checks."""
    k = x["launches"]
    log(f"[examples] {run.label} ({run.example} {' '.join(run.argv)}"
        f"{', from ' + run.params.__name__ if run.params else ''}): wall "
        f"{x['wall_s']:.2f} s (checks {x['checks_s']:.2f} s); "
        + run.line(x) + f"; launches K1 {k['k1']}, K2 {k['k2']}, k2_grad "
        f"{k['k2_grad']}, K3 {k['k3']}")


#: the fresh-process count of each kernel in ``[examples]``
EXAMPLE_FRESH = {"k1": "k1_quickstart_partition", "k2": "k2_gnn_layer",
                 "k2_grad": "k2_grad_gnn_layer"}


def examples_slice(device, workdir: str) -> dict:
    """``main``'s ``[examples]`` phase, also run alone to rehearse it:
    :func:`phase_examples`, then the CUDA launches per call of K1 at the
    streamed partition of the quickstart's rmat(20, 16) and of K2 and its
    backward at the GNN example's full-graph layer, counted in a fresh
    process (:func:`fresh_k2_launches`), each > 0."""
    from repro_torch.core.compbin import bytes_per_vertex

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = phase_examples(device, workdir)
    r["wall_s"] = time.perf_counter() - t0
    runs = r["runs"]
    ids, n, d = runs["gnn"]["checks"]["k2_case"]
    for x in runs.values():
        x["checks"].pop("k2_case", None)
    qs = runs["quickstart_compbin"]
    k1_shape = (stream_bucket_ids(-(-qs["edges"]
                                    // qs["stream"]["partitions"])),
                bytes_per_vertex(qs["vertices"]))
    fresh = fresh_k2_launches(
        {EXAMPLE_FRESH["k2"]: (ids, n, d, False),
         EXAMPLE_FRESH["k2_grad"]: (ids, n, d, True)}, workdir,
        k1_cases={EXAMPLE_FRESH["k1"]: k1_shape})
    for label, got in fresh.items():
        assert got is not None and got[0] > 0, (label, got)
    r["fresh_launches_per_call"] = fresh
    shutil.rmtree(os.path.join(workdir, "examples"), ignore_errors=True)
    for run in EXAMPLE_RUNS:
        log_example(run, runs[run.label])
    log(f"[examples] CUDA launches per call (profiler, {TRACE_CALLS} calls "
        f"in a fresh process): K1 at b={k1_shape[1]} n={k1_shape[0]} (a "
        f"streamed partition of rmat(20, 16)) "
        f"{fresh['k1_quickstart_partition']}; "
        f"K2 at f32[{ids.numel()},{d}] -> [{n},{d}] (the GNN example's "
        f"full-graph layer) {fresh['k2_gnn_layer']}; k2_grad at the same "
        f"{fresh['k2_grad_gnn_layer']} (each: the kernel's own, all, "
        f"device ms)")
    log(f"[examples] main-path launches: " + ", ".join(
        f"{k} {v}" for k, v in r["main_launches"].items())
        + f"; phase wall {r['wall_s']:.1f} s")
    return r


def examples_kernel_entry(r: dict, key: str) -> dict:
    """The ``examples`` entry of a kernel's item in the kernels line: its
    launches by run of ``[examples]`` and per call in a fresh process."""
    return {"launches": {label: x["launches"][key]
                         for label, x in r["runs"].items()},
            "cuda_launches_per_call": r["fresh_launches_per_call"][
                EXAMPLE_FRESH[key]]}


# ---------------------------------------------------------------------------
# [compile]: the graph compiler on the load file, then a cold engine on
# the compiled file answering the hot-set trace
# ---------------------------------------------------------------------------

def phase_compile(csr, path: str, device, workdir: str, *,
                  n_batches: int = 48, batch: int = 1024,
                  seed: int = 0) -> dict:
    """``compile_graph`` the CompBin file at ``path`` (the policy's
    strategy), then replay :func:`phase_hotset`'s trace, mapped through
    ``new_of_old``, through a cold engine (the same mount and
    ``decode="auto"``) on the compiled file.  Every answer, mapped back
    through the sidecar, must equal ``csr``'s row as int64; K1's launch
    delta must equal the engine's device batches."""
    from repro_torch.graph.reorder import (compile_graph, invert_permutation,
                                           map_back, read_sidecar)

    on_gpu = torch.device(device).type == "cuda"
    amode = policy.choose_access_mode("serve")
    out_path = os.path.join(workdir, "compiled_" + os.path.basename(path))
    t0 = time.perf_counter()
    rep = compile_graph(path, out_path, codec="compbin")
    compile_s = time.perf_counter() - t0
    want_strategy = policy.choose_reorder(csr.n_vertices,
                                          csr.n_edges).strategy
    assert rep.strategy == want_strategy, (rep.strategy, want_strategy)
    old_of_new = read_sidecar(rep.sidecar_path)
    new_of_old = invert_permutation(old_of_new)
    degrees = np.diff(csr.offsets)
    trace, _ = hotset_trace(degrees, n_batches, batch, seed=seed)
    pg_budget = max(64 * SERVE_BLOCK_SIZE, os.path.getsize(out_path) // 2)
    launches0 = compbin_decode.launches
    lat, checked = [], 0
    with open_graph(out_path, use_pgfuse=True,
                    pgfuse_block_size=SERVE_BLOCK_SIZE,
                    pgfuse_readahead=amode.readahead,
                    pgfuse_eviction=amode.eviction,
                    pgfuse_max_resident_bytes=pg_budget) as g, \
            NeighborQueryEngine(g, decode="auto", device=device) as eng:
        for vs in trace:
            t1 = time.perf_counter()
            ans = eng.neighbors_batch(new_of_old[vs])
            lat.append(time.perf_counter() - t1)
            back = [map_back(old_of_new, a) for a in ans]
            checked += _check_answers(csr, vs, back)
        qs = eng.stats.as_dict()
        pg = g.fs.stats().as_dict()
    launched = compbin_decode.launches - launches0
    assert launched == (qs["device_batches"] if on_gpu else 0), \
        (launched, qs["device_batches"])
    p50, p99 = _quantiles(lat)
    return {"strategy": rep.strategy, "reason": rep.reason,
            "compile_s": compile_s, "in_bytes": rep.in_bytes,
            "out_bytes": rep.out_bytes,
            "sidecar_bytes": os.path.getsize(rep.sidecar_path),
            "verified_vertices": rep.verified_vertices,
            "batches": n_batches, "batch": batch, "p50_s": p50,
            "p99_s": p99, "latency_s": lat, "ids_checked": checked,
            "pgfuse_hit_rate": pg["hit_rate"],
            "blocks_touched": qs["blocks_touched"],
            "launches": launched, "device_batches": qs["device_batches"],
            "query_batches": qs["batches"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="RMAT scale of the load/serve graph (2^scale "
                         "vertices, 16 edges each before dedup; 22 since "
                         "the MoE and LM training phases joined the run, "
                         "to keep it well inside its time limit)")
    ap.add_argument("--logcsr-scale", type=int, default=16)
    ap.add_argument("--large-log2", type=int, default=28,
                    help="log2 of the id count of the timed kernel cases")
    ap.add_argument("--gnn-scale", type=int, default=18,
                    help="RMAT scale of the graph GCN serving reads "
                         "(edge factor 16, gcn-cora's full width)")
    ap.add_argument("--gnn-requests", type=int, default=8,
                    help="GCN (and PNA) inference requests of 1024 seeds "
                         "each")
    ap.add_argument("--lm-batch", type=int, default=8,
                    help="prompts per LM serving batch (smollm-360m, full "
                         "width and depth, bf16)")
    ap.add_argument("--lm-prompt-len", type=int, default=1024)
    ap.add_argument("--lm-tokens", type=int, default=64,
                    help="tokens generated per prompt (1 prefill + the "
                         "rest decode steps)")
    ap.add_argument("--lm-layers", type=int, default=None,
                    help="cut smollm-360m's depth (default: all 32)")
    ap.add_argument("--out", default=None,
                    help="also write the full results as JSON to this path")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    # f32 products in IEEE f32 (the served-logits tolerance assumes it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: device and toolchain
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    nvcc = build.find_nvcc()
    nvcc_version = subprocess.run([nvcc, "--version"], check=True,
                                  capture_output=True, text=True
                                  ).stdout.strip().splitlines()[-2]
    log(f"[device] {smi}")
    log(f"[device] python {sys.version.split()[0]}  torch {torch.__version__}"
        f"  cuda {torch.version.cuda}  nvcc: {nvcc_version}")

    # phase 2: build every kernel, one compiler process per source
    t0 = time.perf_counter()
    ptxas = build.build_all(extra_flags=("-Xptxas", "-v"))
    build.load_library("compbin_decode")
    build.load_library("segment_sum")
    build.load_library("flash_attention")
    log(f"[build] {len(ptxas)} kernel source(s) in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{k} {build.build_seconds[k]:.1f} s" for k in ptxas))
    for name, out in ptxas.items():
        regs = [int(line.split("Used")[1].split()[0])
                for line in out.splitlines() if "registers" in line]
        spills = [line for line in out.splitlines()
                  if "spill" in line and "0 bytes spill stores, 0 bytes spill "
                  "loads" not in line]
        if not regs:
            log(f"[build] {name}: library already built (no ptxas report)")
            continue
        log(f"[build] {name}: {len(regs)} kernels, registers "
            f"{min(regs)}-{max(regs)} per thread, "
            f"{len(spills)} with spills (ptxas -v)")
    k3_build = k3_instantiations(ptxas["flash_attention"], nvcc)
    for row in k3_build:
        log(f"[build] flash_attention {row['kernel']}: {row['registers']} "
            f"registers, {row['smem_bytes']} B dynamic shared memory, spill "
            f"stores/loads {row['spill_stores']}/{row['spill_loads']} B")

    # phase 3: kernels vs plain versions on the card
    large = phase_kernel_checks(args.large_log2)
    k2_checks = phase_segment_sum_checks()
    det = k2_checks["determinism"]
    log(f"[kernel] segment_sum: {k2_checks['cases']} cases (designs "
        f"{'/'.join(K2_DESIGNS)} and the public path x the JAX sweep's "
        f"{len(K2_SWEEP)} shapes with ids in [-1,N) and [-1,N+3) and "
        f"layouts {', '.join(K2_LAYOUTS)} x f32/bf16, E=0/N=0/D=0) within "
        f"f32 rtol/atol "
        f"{K2_TOL[torch.float32]}, bf16 {K2_TOL[torch.bfloat16]} of the "
        f"plain version (one_segment bit for bit); int64 ids "
        f"{list(WIDE_IDS)} dropped by both designs; backward bit for bit "
        f"on every case and at D {list(K2_GRAD_WIDTHS)} (grad_out aligned "
        f"and one float off), at every vector width of {list(GRAD_VECS)} "
        f"floats the layout allows, wider ones refused "
        f"({k2_checks['backward_checks']} checks)")
    log(f"[kernel] segment_sum rows on the served layout (E={det['e']}, "
        f"{det['valid_edges']} valid, D={det['d']}, N={det['n']}): bit-"
        f"identical across two calls; equal to the CPU plain version bit "
        f"for bit: {det['rows_equal_cpu_plain']} (max abs err "
        f"{det['max_abs_err_vs_cpu_plain']:.3g})")
    k3_cases = phase_flash_checks()

    results = {"device": smi, "kernel_large": large}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        csr, path, gen_s, write_s = make_graph(args.scale, workdir)
        log(f"[graph] rmat({args.scale}, 16): {csr.n_vertices} vertices, "
            f"{csr.n_edges} edges, file {os.path.getsize(path)} bytes; "
            f"generated in {gen_s:.1f} s, written in {write_s:.1f} s")

        # phases 4-6: the main path, launch counter zeroed just before
        compbin_decode.launches = 0
        load = phase_load(csr, path, device)
        log(f"[load] scale {args.scale}: {load['partitions']} partitions, "
            f"b={load['b']}, wall {load['wall_s']:.3f} s, "
            f"{load['edges_per_s']:.4g} edges/s, "
            f"H2D {load['h2d_bytes_per_s']:.4g} B/s "
            f"({load['bytes_h2d']} bytes), decode_s {load['decode_s']:.3f}, "
            f"launches {load['launches']}, host_decode_bytes 0, "
            f"CSR equal bit for bit")
        serve = phase_serve(csr, path, device)
        log(f"[serve] {serve['batches']} batches ({serve['device_batches']} "
            f"on device), {serve['requests']} requests, "
            f"{serve['edges_returned']} edges, p50 {serve['p50_s'] * 1e3:.3f} "
            f"ms, p99 {serve['p99_s'] * 1e3:.3f} ms per 1024-vertex batch, "
            f"bytes_h2d {serve['bytes_h2d']}, auto: "
            f"{serve['auto_device_batches']}/{serve['auto_batches']} on "
            f"device, launches {serve['launches']}, "
            f"{serve['ids_checked']} ids equal the CSR")
        log("[serve] exclusive ms per traced batch by tier: " + ", ".join(
            f"{t} {s * 1e3:.3f}" for t, s in
            sorted(serve["tier_s_per_traced_batch"].items())))
        logcsr = phase_logcsr(device, args.logcsr_scale, workdir)
        log(f"[logcsr] scale {args.logcsr_scale}: load launches "
            f"{logcsr['load']['launches']}, serve launches "
            f"{logcsr['serve']['launches']}, all answers equal")
        main_path_launches = compbin_decode.launches
        assert main_path_launches == (load["launches"] + serve["launches"]
                                      + logcsr["load"]["launches"]
                                      + logcsr["serve"]["launches"])
        assert load["launches"] > 0 and serve["launches"] > 0

        # phases 6b-6c: the serving stack above the engine on the same
        # file -- the hot-set tier, then traversals on one engine and on
        # 2 shards x 2 replicas with a hot set; K1's count zeroed just
        # before each run and read just after
        compbin_decode.launches = 0
        hot = phase_hotset(csr, path, device)
        hot_k1 = compbin_decode.launches
        assert hot_k1 == hot["launches"] > 0, (hot_k1, hot["launches"])
        hs = hot["hot"]["hotset"]
        log(f"[hotset] {hot['batches']} batches of {hot['batch']} "
            f"(60 % on the {hot['hubs']} top-degree hubs, "
            f"{hot['hub_edges']} hub edges), budget {hot['budget_bytes']} "
            f"B: cold p50 {hot['cold']['p50_s'] * 1e3:.3f} ms p99 "
            f"{hot['cold']['p99_s'] * 1e3:.3f} ms, hot p50 "
            f"{hot['hot']['p50_s'] * 1e3:.3f} ms p99 "
            f"{hot['hot']['p99_s'] * 1e3:.3f} ms (hot/cold p50 "
            f"{hot['hot_over_cold_p50']:.3f}); hit rate "
            f"{hs['hit_rate']:.4f} ({hs['hits']}/{hs['lookups']}), "
            f"{hs['resident_entries']} resident entries, "
            f"{hs['resident_bytes']} B charged, {hs['pinned']} pinned, "
            f"{hot['hot']['card_bytes']} B on the card "
            f"(memory_allocated), {hot['hot']['lookup_us_per_hit']:.2f} us "
            f"a hit (lookup of 1024 resident runs); K1 launches cold "
            f"{hot['cold']['launches']} / hot {hot['hot']['launches']} "
            f"(= device batches {hot['cold']['device_batches']} / "
            f"{hot['hot']['device_batches']} of {hot['cold']['batches']}); "
            f"{hot['cold']['ids_checked'] + hot['hot']['ids_checked']} ids "
            f"equal the CSR; phase wall {hot['wall_s']:.1f} s")
        for arm in ("cold", "hot"):
            log(f"[hotset] {arm} exclusive ms per traced batch by tier: "
                + ", ".join(f"{t} {sec * 1e3:.3f}" for t, sec in sorted(
                    hot[arm]["tier_s_per_traced_batch"].items())))
        trav, trav_k1 = {}, 0
        for label, kw in (("one_engine", {}),
                          ("sharded", dict(shards=2, replication=2,
                                           hotset_bytes=TRAVERSAL_HOTSET))):
            compbin_decode.launches = 0
            r = trav[label] = phase_traversal(csr, path, device, **kw)
            assert compbin_decode.launches == r["launches"] > 0, \
                (compbin_decode.launches, r["launches"])
            trav_k1 += r["launches"]
            log(f"[traversal] {label} ({r['shards']} shard(s) x "
                f"{r['replication']} replica(s), hot set "
                f"{r['hotset_bytes']} B per engine): {r['completed']}/"
                f"{r['requests']} completed, shed {r['shed']} (rate "
                f"{r['shed_rate']:.4f}); per kind one at a time (ms): "
                + ", ".join(
                    f"{k} n={v['n']} p50 {v['p50_s'] * 1e3:.3f}"
                    + (f" p99 {v['p99_s'] * 1e3:.3f}"
                       if v["p99_s"] is not None else "")
                    + f" max {v['max_s'] * 1e3:.3f}"
                    for k, v in r["per_kind"].items())
                + f"; service p50 {r['p50_s'] * 1e3:.3f} ms p99 "
                f"{r['p99_s'] * 1e3:.3f} ms; {r['frontier_batches']} "
                f"frontier batches, {r['edges_scanned']} edges scanned, "
                f"{r['paths_found']} paths found; K1 launches "
                f"{r['launches']} = device batches {r['device_batches']} "
                f"of {r['engine_batches']}; {r['executor_threads']} "
                f"executor threads; {r['vertices_checked']} visited "
                f"vertices equal the plain numpy traversal"
                + (f"; hot set hit rate {r['hotset']['hit_rate']:.4f}"
                   if "hotset" in r else "")
                + f"; phase wall {r['wall_s']:.1f} s")
            for kind, v in r["per_kind"].items():
                log(f"[traversal] {label} {kind}: exclusive ms per request "
                    f"by tier: " + ", ".join(
                        f"{t} {sec * 1e3:.3f}" for t, sec in
                        sorted(v["tier_s_per_request"].items())))

        # phase 7: host vs device crossover, and the copy it rides on
        cross = phase_crossover(path, device)
        h2d = phase_h2d()

        # phase 8: K1 at the shape the load path gives it (one padded
        # partition of the graph above)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        flush = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
        k1 = measure_kernel(
            random_packed(load["max_partition_ids"], load["b"], gen),
            load["b"], flush)
        log(f"[kernel] main-path shape b={k1['b']} n={k1['n']}: kernel "
            f"{k1['ms']:.4f} ms  bound {k1['bound_ms']:.4f} ms  "
            f"{k1['gb_per_s']:.1f} GB/s  plain {k1['plain_ms']:.4f} ms")

        # phase 9: GCN inference serving at gcn-cora's full width, both
        # launch counters zeroed just before
        compbin_decode.launches = 0
        segment_sum.launches = 0
        gnn = phase_gnn(device, workdir, scale=args.gnn_scale,
                        n_requests=args.gnn_requests)
        gnn_k1, gnn_k2 = compbin_decode.launches, segment_sum.launches
        assert (gnn_k1, gnn_k2) == (gnn["k1_launches"], gnn["k2_launches"])
        assert gnn_k1 > 0 and gnn_k2 > 0
        log(f"[gnn] {gnn['arch']} (d_in {gnn['d_in']}, d_hidden "
            f"{gnn['d_hidden']}, {gnn['n_classes']} classes) on "
            f"rmat({gnn['scale']}, {gnn['edge_factor']}): "
            f"{gnn['vertices']} vertices, files {gnn['file_bytes']}, assets "
            f"in {gnn['assets_s']:.1f} s")
        log(f"[gnn] {gnn['requests']} requests of {gnn['batch']} seeds, "
            f"fanouts {gnn['fanouts']}: {gnn['nodes_per_request']} nodes, "
            f"{gnn['edge_slots_per_request']} edge slots "
            f"({gnn['valid_edges_last_request']} valid in the last), "
            f"{gnn['feature_bytes_per_request']} feature bytes per request; "
            f"p50 {gnn['p50_s'] * 1e3:.3f} ms, p99 {gnn['p99_s'] * 1e3:.3f} "
            f"ms (requests 2..{gnn['requests']}), first "
            f"{gnn['first_request_s'] * 1e3:.3f} ms; K1 launches {gnn_k1} "
            f"({gnn['device_batches']}/{gnn['query_batches']} query batches "
            f"on device), K2 launches {gnn_k2}; logits within {GNN_TOL} of "
            f"the plain CPU path (max abs err {gnn['max_abs_err']:.3g})")
        log("[gnn] exclusive ms per request by tier: " + ", ".join(
            f"{t} {sec * 1e3:.3f}" for t, sec in
            sorted(gnn["tier_s_per_request"].items())))

        # phase 10: K2 at the three shapes the served block gives it, and
        # at layer 0 with the edges permuted; both designs each
        ids = torch.from_numpy(gnn.pop("edge_dst")).to(device)
        n_nodes = gnn.pop("n_nodes")
        shuffled = ids[torch.randperm(ids.numel(), device=device,
                                      generator=gen)]
        k2 = {}
        for label, d, x in (("layer0", gnn["d_in"], ids),
                            ("layer1", gnn["d_hidden"], ids),
                            ("degree", 1, ids),
                            ("layer0_permuted", gnn["d_in"], shuffled)):
            r = k2[label] = measure_segment_sum(x, d, n_nodes, flush, gen)
            log(f"[kernel] segment_sum {label} E={r['e']} "
                f"({r['valid_edges']} valid) D={r['d']} N={r['n']}: plan "
                f"picks {r['design']}; " + "; ".join(
                    f"{m} {v['ms']:.4f} ms (CUDA launches per call "
                    f"(profiler): {v['k2_launches_per_call']} K2, "
                    f"{v['cuda_launches_per_call']} in all; device ms "
                    + ", ".join(f"{k} {t:.4f}" for k, t in
                                (v["kernel_device_ms"] or {}).items())
                    + f"; max_abs_err {v['max_abs_err']:.3g})"
                    for m, v in r["designs"].items())
                + f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"{r['gb_per_s']:.1f} GB/s; plain {r['plain_ms']:.4f} ms; "
                f"library_ms (index_add_) {r['library_ms']:.4f}")

        check_k2_plan_picks_the_faster({label: k2[label] for label in (
            "layer0", "layer1", "degree")})
        k2_limits = phase_k2_plan_limits(ids, n_nodes, flush, gen)
        for sweep, rows in k2_limits.items():
            log(f"[kernel] segment_sum plan limits, {sweep} (ms atomic / "
                f"rows, plan's pick): " + "; ".join(
                    f"{key}: {r['atomic']:.4f} / {r['rows']:.4f} "
                    f"{r['plan']}" for key, r in rows.items()))

        # phase 11: LM serving at smollm-360m's full width, K3 path vs the
        # plain attention path in f32 on the same card
        spec = get_arch("smollm-360m")
        lm_cfg = spec.make_config()
        if args.lm_layers:
            lm_cfg = dataclasses.replace(lm_cfg, n_layers=args.lm_layers)
        lm_check = phase_lm_check(device, dataclasses.replace(
            lm_cfg, dtype=torch.float32), batch=2, prompt_len=512, n_tokens=8)
        assert lm_check["launches"] == lm_cfg.n_layers * 8, lm_check["launches"]
        full, yard = (lm_check["full_depth_k3_vs_plain"],
                      lm_check["full_depth_dense_vs_chunked"])
        sh = {k[7:]: x for k, x in lm_check.items() if k.startswith("shadow_")}
        log(f"[lm] {lm_cfg.name} f32 ({lm_cfg.n_layers} layers, d_model "
            f"{lm_cfg.d_model}, {lm_cfg.n_heads}/{lm_cfg.n_kv_heads} heads, "
            f"vocab {lm_cfg.vocab}): batch 2 x 512-token prompts, 8 tokens; "
            f"{sh['calls']} attention calls on the K3 path each within rtol "
            f"{K3_TOL[torch.float32]}, atol {K3_TOL[torch.float32]} x max(1, "
            f"max|v|) (per call {sh['atol_min']:.4g}-{sh['atol_max']:.4g}) of "
            f"f64 attention on the same inputs (max abs err "
            f"{sh['max_abs_err']:.3g}, at most {sh['worst_err_over_atol']:.3g} "
            f"of its call's atol; the plain f32 path's "
            f"{sh['plain_max_abs_err']:.3g}); {lm_check['launches']} K3 "
            f"launches")
        log(f"[lm] end to end at {lm_check['e2e_layers']} layers: logits within "
            f"{LM_TOL} of the plain path (max abs err "
            f"{lm_check['max_abs_err']:.3g} over {lm_check['steps_compared']} "
            f"row-steps), {len(lm_check['flips'])} token flips")
        log(f"[lm] end to end at {lm_cfg.n_layers} layers (reported): K3 vs "
            f"plain max abs logit diff {full['max_abs_err']:.3g}, tokens equal "
            f"{full['tokens_equal']:.3f}; the plain path's dense vs chunked "
            f"backends {yard['max_abs_err']:.3g}, tokens equal "
            f"{yard['tokens_equal']:.3f}")

        # phase 12: LM serving in bf16 after a short warm-up (cuBLAS picks
        # its bf16 kernels), the K3 launch counter zeroed just before the
        # timed run
        from repro_torch.models import transformer as tf
        lm_params = tf.init_params(lm_cfg, torch.Generator(device=device)
                                   .manual_seed(0))
        from repro_torch.launch.serve import serve_lm
        serve_lm(lm_cfg, batch=args.lm_batch, prompt_len=args.lm_prompt_len,
                 n_tokens=2, device=device, params=lm_params)   # warm-up
        flash_attention.launches = 0
        lm = phase_lm_serve(device, lm_cfg, args.lm_batch, args.lm_prompt_len,
                            args.lm_tokens, params=lm_params)
        lm_k3 = flash_attention.launches
        # after the count: where the card's time goes, by kernel class
        lm["device_split"] = split = lm_device_split(
            lm_cfg, lm_params, args.lm_batch, args.lm_prompt_len, 3)
        assert lm_k3 == lm["launches"] == lm_cfg.n_layers * args.lm_tokens, \
            (lm_k3, lm["launches"])
        # the served dtype at full depth, every attention call held to f64 on
        # the same inputs (prefill: tc_prefill; decode steps: split_decode)
        shadow = phase_lm_shadow(device, lm_cfg, lm_params, args.lm_batch,
                                 args.lm_prompt_len, LM_SHADOW_TOKENS)
        del lm_params
        assert shadow["launches"] == shadow["calls"], shadow
        log(f"[lm] {lm_cfg.name} bf16: {args.lm_batch} x {args.lm_prompt_len}"
            f"-token prompts, {args.lm_tokens} tokens: prefill "
            f"{lm['prefill_ms']:.3f} ms ({lm['prefill_flops']:.4g} FLOP by "
            f"lm_model_flops, {lm['prefill_flops_per_s'] / 1e12:.2f} TFLOP/s = "
            f"{100 * lm['prefill_bf16_peak_share']:.2f} % of 989 TFLOP/s), "
            f"decode {lm['decode_ms_per_step']:.3f} ms per step, "
            f"{lm['tokens_per_s']:.1f} tokens/s; K3 launches {lm_k3} "
            f"({lm_cfg.n_layers} prefill + {args.lm_tokens - 1} x "
            f"{lm_cfg.n_layers} decode)")
        g, pairs = lm_cfg.n_heads // lm_cfg.n_kv_heads, \
            args.lm_batch * lm_cfg.n_kv_heads
        prefill_design = plan(lm_cfg.dtype, g * args.lm_prompt_len,
                              args.lm_prompt_len, lm_cfg.d_head, pairs)[0]
        decode_design = plan(lm_cfg.dtype, g, args.lm_prompt_len + 1,
                             lm_cfg.d_head, pairs)[0]
        log(f"[lm] {lm_cfg.name} bf16 shadow: {args.lm_batch} x "
            f"{args.lm_prompt_len}-token prompts, {LM_SHADOW_TOKENS} "
            f"tokens, {shadow['calls']} attention calls on the K3 path "
            f"(prefill {prefill_design}, decode {decode_design}) each within "
            f"rtol {K3_TOL[torch.bfloat16]}, atol {K3_TOL[torch.bfloat16]} x "
            f"max(1, max|v|) (per call {shadow['atol_min']:.4g}-"
            f"{shadow['atol_max']:.4g}) of f64 attention on the same inputs "
            f"(max abs err {shadow['max_abs_err']:.3g}, at most "
            f"{shadow['worst_err_over_atol']:.3g} of its call's atol; the plain "
            f"bf16 path's {shadow['plain_max_abs_err']:.3g}); "
            f"{shadow['launches']} K3 launches")
        for part, sp in split.items():
            dev = sp["device_ms"]
            log(f"[lm] {part} (torch.profiler, per "
                f"{'prefill' if part == 'prefill' else 'decode step'}): wall "
                f"{sp['wall_ms']:.3f} ms; device "
                + ("not measured (no device time in the trace)" if dev is None
                   else ", ".join(f"{k} {v:.3f} ms" for k, v in dev.items())
                   + f"; idle share {sp['idle_share']:.3f}"))
            log(f"[lm] {part} top kernels (ms, launches, name): " + "; ".join(
                f"{ms:.3f} {n} {name}" for ms, n, name in sp["top_kernels"]))

        # phase 13: K3 per design: the two served shapes (bf16) and the f32
        # correctness run's two
        gen = torch.Generator(device="cuda")
        gen.manual_seed(4)
        k3 = {}
        for kind in K3_SHAPES:
            r = k3[kind] = measure_flash(kind, flush, gen)
            log(f"[kernel] flash_attention {kind} ({r['design']}, nsplit "
                f"{r['nsplit']}, CUDA launches per call (profiler) "
                f"{r['cuda_launches_per_call'] or 'not measured'}) "
                f"{r['dtype']} q[{r['b']},{r['hq']},{r['sq']},{r['dh']}] over "
                f"{r['kv_len']} keys x {r['hkv']} heads: kernel "
                f"{r['ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})  {r['tflop_per_s']:.2f} TFLOP/s  "
                f"{r['gb_per_s']:.1f} GB/s  plain {r['plain_ms']:.4f} ms  "
                + "  ".join(f"{name} {t:.4f} ms"
                            for name, t in r["library"].items())
                + f"  max_abs_err {r['max_abs_err']:.3g}")
        # phase 14: [train] gcn-cora training at full width on the GNN
        # phase's assets; K1's and both of K2's counts zeroed just before
        # and read just after
        del flush
        torch.cuda.empty_cache()
        compbin_decode.launches = 0
        segment_sum.launches = segment_sum.grad_launches = 0
        trn = phase_train(device, workdir, scale=args.gnn_scale)
        train_k1 = compbin_decode.launches - trn["k1_check_launches"]
        train_k2, train_k2b = segment_sum.launches, segment_sum.grad_launches
        assert train_k1 == trn["k1_launches"] > 0, (train_k1, trn)
        assert (train_k2, train_k2b) == (trn["k2_launches"],
                                         trn["k2_grad_launches"]), \
            (train_k2, train_k2b)
        assert train_k2 > 0 and train_k2b > 0
        books = trn["stats_hosts_vs_one"]
        log(f"[train] {trn['arch']} (d_in {trn['d_in']}, d_hidden "
            f"{trn['d_hidden']}, {trn['n_classes']} classes) --full-graph "
            f"on {trn['hosts']} simulated hosts, rmat({trn['scale']}, "
            f"{trn['edge_factor']}): {trn['vertices']} vertices, "
            f"{trn['edges']} edges; load {trn['load_s']:.3f} s (per host "
            + ", ".join(f"{t:.3f}" for t in trn["host_load_s"])
            + f" s; ranges {trn['host_ranges']}, partitions "
            f"{trn['host_partitions']}, align {trn['align']}); summed over "
            f"hosts = one host's: " + ", ".join(
                f"{k} {books[k][0]}" for k in STREAM_DATA_COUNTERS)
            + f" (cut-dependent, hosts / one: partitions "
            f"{books['partitions'][0]} / {books['partitions'][1]}, bytes_h2d "
            f"{books['bytes_h2d'][0]} / {books['bytes_h2d'][1]}); 0 bytes "
            f"decoded on the host")
        log(f"[train] {len(trn['losses'])} AdamW steps: loss "
            f"{trn['losses'][0]:.6f} -> {trn['losses'][-1]:.6f}; step p50 "
            f"{trn['step_p50_s'] * 1e3:.3f} ms (steps "
            + ", ".join(f"{t * 1e3:.1f}" for t in trn["step_s"])
            + f" ms); max_memory_allocated {trn['max_memory_allocated']} B; "
            f"K2 a step: {trn['k2_per_step'][0]} forward, "
            f"{trn['k2_per_step'][1]} backward (asserted every step)")
        sp = trn.get("step_split") or {}
        log(f"[train] one full-graph step (torch.profiler): wall "
            f"{sp.get('wall_ms', float('nan')):.3f} ms; device "
            + ("not measured (no device time in the trace)"
               if not sp.get("device_ms") else ", ".join(
                   f"{k} {v:.3f} ms" for k, v in sp["device_ms"].items())
               + f"; idle share {sp['idle_share']:.3f}; top kernels (ms, "
               f"launches, name): " + "; ".join(
                   f"{ms:.3f} {n} {name}" for ms, n, name in
                   sp["top_kernels"])))
        rs, par, smp = trn["restart"], trn["parity"], trn["sampled"]
        log(f"[train] restart: failure injected at step {rs['fail_at']}, "
            f"checkpoints every {rs['ckpt_every']}, "
            f"{rs['steps_replayed']} step(s) replayed; resumed from the "
            f"checkpointed state bit for bit; losses after the restore "
            f"within {rs['loss_rel_err']:.3g} (<= {TRAIN_LOSS_RTOL}) of the "
            f"uninjected run's; final params off the uninjected run's by "
            + ", ".join(f"{k} {d['share']:.3g} (max abs {d['max_abs']:.3g})"
                        for k, d in rs["drift"].items())
            + f" of the distance it moved (<= {RESTART_PARAM_SHARE}); a "
            f"second uninjected run is off by " + ", ".join(
                f"{k} {d['share']:.3g} (max abs {d['max_abs']:.3g})"
                for k, d in rs["noise_floor"].items()))
        log(f"[train] parity at rmat({par['scale']}, {trn['edge_factor']}) "
            f"({par['vertices']} vertices, {par['edges']} edges): first-step "
            f"loss {par['loss']:.7f} vs plain {par['plain_loss']:.7f} (rel "
            f"err {par['loss_rel_err']:.3g} <= {TRAIN_LOSS_RTOL}); grads "
            f"within rtol {TRAIN_GRAD_TOL[0]}, atol {TRAIN_GRAD_TOL[1]} x "
            f"max|g| (max abs err " + ", ".join(
                f"{k} {v:.3g}" for k, v in par["grad_max_abs_err"].items())
            + ")")
        log(f"[train] --sampled: {smp['steps']} steps of {smp['seeds']} "
            f"seeds ({smp['nodes']} nodes, {smp['edges']} edge slots, "
            f"{smp['valid_edges']} valid in the last): fetch p50 "
            f"{smp['fetch_p50_s'] * 1e3:.3f} ms, step p50 "
            f"{smp['step_p50_s'] * 1e3:.3f} ms, total p50 "
            f"{smp['total_p50_s'] * 1e3:.3f} ms; loss {smp['losses'][0]:.4f} "
            f"-> {smp['losses'][-1]:.4f}; K1 launches {smp['k1_launches']} "
            f"= device batches {smp['device_batches']} of "
            f"{smp['query_batches']}")
        log(f"[train] main-path launches: K1 {train_k1}, K2 forward "
            f"{train_k2}, K2 backward {train_k2b}; phase wall "
            f"{trn['wall_s']:.1f} s")

        # phase 15: K2 at the full-graph training shapes (forward, both
        # designs, after [train] has freed its tensors), then K2's
        # backward at the two training shapes
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        gc.collect()
        torch.cuda.empty_cache()
        flush = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
        full_ids = trn.pop("full_graph_ids")
        k2f = measure_segment_sum_full_graph(
            full_ids, trn["vertices"], (trn["d_in"], trn["d_hidden"], 1),
            flush, gen)
        for r in k2f["widths"].values():
            log(f"[kernel] segment_sum full graph D={r['d']}: f32[{r['e']},"
                f"{r['d']}] by unsorted int32[{r['e']}] ({r['valid_edges']} "
                f"valid) -> f32[{r['n']},{r['d']}]; plan picks "
                f"{r['design']}, fastest {r['fastest']}; " + "; ".join(
                    f"{m} {v['ms']:.4f} ms" for m, v in r["designs"].items())
                + f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"{r['gb_per_s']:.1f} GB/s; plain {r['plain_ms']:.4f} ms; "
                f"library_ms (index_add_) {r['library_ms']:.4f}; bit for "
                f"bit equal to the plain version (integer messages)")
        log(f"[kernel] segment_sum full graph: max_memory_allocated "
            f"{k2f['max_memory_allocated']} B")
        k2g = {}
        grad_cases = {"full_graph": (full_ids, trn["vertices"]),
                      "sampled": (trn.pop("sampled_ids"), smp["nodes"])}
        fresh = fresh_k2_grad_launches(grad_cases, trn["d_hidden"], workdir)
        for label, (ids_t, n) in grad_cases.items():
            r = k2g[label] = measure_segment_sum_grad(
                ids_t, trn["d_hidden"], n, flush, gen)
            counted = fresh[label] or (None, None, None)
            r.update(k2_launches_per_call=counted[0],
                     cuda_launches_per_call=counted[1],
                     kernel_device_ms=counted[2])
            launches = ("not measured" if counted[0] is None
                        else f"{counted[0]} K2, {counted[1]} in all, over "
                        f"{TRACE_CALLS} calls in a fresh process")
            log(f"[kernel] segment_sum backward {label}: grad f32[{r['n']},"
                f"{r['d']}] gathered by int32[{r['e']}] ({r['valid_edges']} "
                f"valid, {r['grad_rows_read']} distinct rows): kernel "
                f"{r['ms']:.4f} ms at VEC {r['vec']} (CUDA launches per "
                f"call (profiler): {launches})  bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})  "
                f"{r['gb_per_s']:.1f} GB/s  plain {r['plain_ms']:.4f} ms  "
                f"library_ms {r['library_ms']:.4f} ({r['library_call']}; "
                + ", ".join(f"{k} {v:.4f}" for k, v in r["library"].items())
                + "); bit for bit equal to the plain version")
        del flush, full_ids, grad_cases
        torch.cuda.empty_cache()

        # phase 15b: [gnn2] PNA served and trained, MeshGraphNet and
        # DimeNet trained, at full width; K1's and both of K2's counts
        # zeroed just before and read just after
        gc.collect()
        torch.cuda.empty_cache()
        compbin_decode.launches = 0
        segment_sum.launches = segment_sum.grad_launches = 0
        g2 = phase_gnn2(device, workdir, scale=args.gnn_scale,
                        n_requests=args.gnn_requests)
        g2_k1, g2_k2, g2_k2b = (compbin_decode.launches, segment_sum.launches,
                                segment_sum.grad_launches)
        assert (g2_k1, g2_k2, g2_k2b) == (
            g2["k1_launches"], g2["k2_launches"], g2["k2_grad_launches"]), \
            (g2_k1, g2_k2, g2_k2b, g2)
        assert g2_k1 > 0 and g2_k2 > 0 and g2_k2b > 0
        log_gnn2(g2)
        log(f"[gnn2] main-path launches: K1 {g2_k1}, K2 forward {g2_k2}, K2 "
            f"backward {g2_k2b}; phase wall {g2['wall_s']:.1f} s")

        # phase 15c: K2 and its backward at [gnn2]'s shapes, each held to
        # its plain version bit for bit (integer messages), then timed
        shapes = gnn2_k2_shapes(g2)
        k2_shape_checks = check_k2_shapes(shapes)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(7)
        gc.collect()
        torch.cuda.empty_cache()
        flush = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
        k2n = {}
        for label, (ids_t, n, d, backward) in shapes.items():
            r = k2n[label] = measure_segment_sum_full_graph(
                ids_t, n, (d,), flush, gen)["widths"][d]
            r["checks"] = k2_shape_checks[label]["checks"]
            if backward:
                r["backward"] = measure_segment_sum_grad(ids_t, d, n, flush,
                                                         gen)
            log_k2_shape(label, r)
        del flush, shapes
        gc.collect()
        torch.cuda.empty_cache()

        # phases 15d-15f: [moe], [lm_train], then K2, its backward and K3
        # at their shapes
        ms = moe_slice(device, workdir)
        moe, lmt, k2m, k3m = ms["moe"], ms["lm_train"], ms["k2"], ms["k3"]
        moe_k3, moe_k2 = moe["k3_launches"], moe["k2_launches"]
        lmt_k2, lmt_k2b = ms["lm_train_k2"], ms["lm_train_k2_grad"]

        # phase 15g: [din] served, scored and trained at full width (10M
        # items), the packed requests decoded by K1; K1's count zeroed just
        # before and read just after (din_slice)
        ds = din_slice(device, workdir)
        din_r, k1d, din_k1 = ds["din"], ds["k1"], ds["k1_launches"]
        k2d = ds["table_grad"]

        # phase 15h: [cells] build_cell's 40 cells (and 3 variants)
        # dry-run on the card mesh, those whose estimate fits run on the
        # card; every count zeroed just before and read just after
        # (cells_slice); then K1, K2, its backward and K3 at the new shapes
        cl = cells_slice(device, workdir)
        cl_k = cl["main_launches"]

        # phase 15i: [examples] the four examples of examples/*_torch.py
        # run in this process at their own sizes, every count zeroed just
        # before each run and read just after (phase_examples); then K1's,
        # K2's and its backward's launches per call at their shapes in a
        # fresh process
        ex = examples_slice(device, workdir)
        ex_k = ex["main_launches"]

        # phase 16: [compile] the load file through the graph compiler,
        # the hot-set trace through a cold engine on the compiled file;
        # K1's count zeroed just before and read just after
        compbin_decode.launches = 0
        comp = phase_compile(csr, path, device, workdir)
        comp_k1 = compbin_decode.launches
        assert comp_k1 == comp["launches"] > 0, (comp_k1, comp["launches"])
        log(f"[compile] rmat({args.scale}, 16) -> compbin, strategy "
            f"{comp['strategy']} ({comp['reason']}): {comp['compile_s']:.1f} "
            f"s, {comp['in_bytes']} -> {comp['out_bytes']} bytes + sidecar "
            f"{comp['sidecar_bytes']} bytes, {comp['verified_vertices']} "
            f"vertices self-verified")
        log(f"[compile] the hot-set trace ({comp['batches']} x "
            f"{comp['batch']}) mapped through new_of_old, cold engine on the "
            f"compiled file: p50 {comp['p50_s'] * 1e3:.3f} ms p99 "
            f"{comp['p99_s'] * 1e3:.3f} ms (original file, [hotset] cold "
            f"arm: p50 {hot['cold']['p50_s'] * 1e3:.3f} ms p99 "
            f"{hot['cold']['p99_s'] * 1e3:.3f} ms); PG-Fuse hit rate "
            f"{comp['pgfuse_hit_rate']:.4f} (original "
            f"{hot['cold']['pgfuse_hit_rate']:.4f}), blocks touched "
            f"{comp['blocks_touched']} (original "
            f"{hot['cold']['blocks_touched']}); K1 launches {comp_k1} = "
            f"device batches {comp['device_batches']} of "
            f"{comp['query_batches']}; {comp['ids_checked']} ids mapped back "
            f"equal the original CSR as int64")
    results.update(load=load, serve=serve, logcsr=logcsr, hotset=hot,
                   traversal=trav, crossover=cross, train=trn, gnn2=g2,
                   segment_sum_gnn2=k2n, moe=moe, lm_train=lmt,
                   segment_sum_moe=k2m, flash_attention_moe=k3m,
                   din=din_r, kernel_din_request=k1d, cells=cl,
                   examples=ex,
                   segment_sum_din_table_grad=k2d,
                   segment_sum_full_graph=k2f,
                   segment_sum_backward=k2g, compile=comp,
                   h2d=h2d, gnn=gnn, segment_sum=k2,
                   segment_sum_checks=k2_checks,
                   segment_sum_plan_limits=k2_limits, flash_attention=k3,
                   flash_attention_cases=k3_cases,
                   flash_attention_build=k3_build, lm_check=lm_check,
                   lm_serve=lm, lm_shadow=shadow,
                   kernel_main_path=k1, graph={
                       "scale": args.scale, "vertices": csr.n_vertices,
                       "edges": csr.n_edges, "generate_s": gen_s,
                       "write_s": write_s})
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    kernels = [{
        "name": "compbin_decode", "route": "cuda", "source": CUDA_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": (main_path_launches + hot_k1 + trav_k1 + gnn_k1
                     + train_k1 + g2_k1 + din_k1 + cl_k["k1"] + ex_k["k1"]
                     + comp_k1),
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
        "shape": f"uint8[{k1['n']}*{k1['b']}] -> int32[{k1['n']}]",
        "din_request": {"shape": f"uint8[{k1d['n']}*{k1d['b']}] -> "
                                 f"int32[{k1d['n']}]",
                        "launches": din_k1, **{key: k1d[key] for key in (
                            "ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "max_abs_err")}},
        "cells": cells_kernel_entry(cl, "compbin_decode"),
        "examples": examples_kernel_entry(ex, "k1"),
    }, {
        "name": "segment_sum", "route": "cuda", "source": K2_CUDA_SOURCE,
        "replaces": K2_TPU_KERNEL,
        "launches": (gnn_k2 + train_k2 + g2_k2 + moe_k2 + lmt_k2 + cl_k["k2"]
                     + ex_k["k2"]),
        "max_abs_err": max(r["max_abs_err"] for r in k2.values()),
        "ms": k2["layer0"]["ms"], "plain_ms": k2["layer0"]["plain_ms"],
        "bound_ms": k2["layer0"]["bound_ms"],
        "bound_by": k2["layer0"]["bound_by"],
        "library_ms": k2["layer0"]["library_ms"],
        "library_call": "zeros(N,D).index_add_",
        "shape": (f"f32[{k2['layer0']['e']},{k2['layer0']['d']}] by "
                  f"int32[{k2['layer0']['e']}] -> "
                  f"f32[{k2['layer0']['n']},{k2['layer0']['d']}] (layer 0)"),
        "design": k2["layer0"]["design"],
        "rows_deterministic": det["rows_equal_across_calls"],
        "rows_equal_cpu_plain": det["rows_equal_cpu_plain"],
        "designs": {label: {"plan": r["design"], **{
            m: {key: v[key] for key in (
                "ms", "k2_launches_per_call", "cuda_launches_per_call",
                "kernel_device_ms", "max_abs_err")}
            for m, v in r["designs"].items()},
            **{key: r[key] for key in ("plain_ms", "bound_ms", "bound_by",
                                       "library_ms")}}
            for label, r in k2.items()},
        "full_graph": {d: {key: r[key] for key in (
            "e", "d", "n", "valid_edges", "design", "fastest", "ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by", "gb_per_s")}
            | {m: v["ms"] for m, v in r["designs"].items()}
            for d, r in k2f["widths"].items()},
        "gnn2": {label: {key: r[key] for key in (
            "e", "d", "n", "valid_edges", "design", "fastest", "ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by", "gb_per_s")}
            | {m: v["ms"] for m, v in r["designs"].items()}
            for label, r in k2n.items()},
        "moe": {label: {key: r[key] for key in (
            "e", "d", "n", "valid_edges", "design", "fastest", "ms",
            "plain_ms", "library_ms", "bound_ms", "bound_by", "gb_per_s",
            "cuda_launches_per_call")}
            | {m: v["ms"] for m, v in r["designs"].items()}
            for label, r in k2m.items()},
        "din_table_grad": {key: k2d[key] for key in (
            "e", "d", "n", "valid_edges", "design", "fastest", "ms",
            "plain_ms", "library_ms", "autograd_ms", "bound_ms", "bound_by",
            "gb_per_s")} | {m: v["ms"] for m, v in k2d["designs"].items()},
        "cells": cells_kernel_entry(cl, "segment_sum"),
        "examples": examples_kernel_entry(ex, "k2"),
    }, {
        "name": "segment_sum_backward", "route": "cuda",
        "source": K2_CUDA_SOURCE, "replaces": K2_TPU_KERNEL,
        "note": ("K2's backward (a gather); the JAX package trains through "
                 "XLA's segment_sum and has no backward kernel"),
        "launches": (train_k2b + g2_k2b + lmt_k2b + cl_k["k2_grad"]
                     + ex_k["k2_grad"]),
        "max_abs_err": 0.0,
        "ms": k2g["full_graph"]["ms"],
        "plain_ms": k2g["full_graph"]["plain_ms"],
        "bound_ms": k2g["full_graph"]["bound_ms"],
        "bound_by": k2g["full_graph"]["bound_by"],
        "library_ms": k2g["full_graph"]["library_ms"],
        "library_call": k2g["full_graph"]["library_call"],
        "shape": (f"f32[{k2g['full_graph']['n']},{k2g['full_graph']['d']}] "
                  f"by int32[{k2g['full_graph']['e']}] -> f32["
                  f"{k2g['full_graph']['e']},{k2g['full_graph']['d']}] "
                  f"(full-graph layer 1)"),
        "vec": k2g["full_graph"]["vec"],
        "shapes": {label: {key: r[key] for key in (
            "e", "d", "n", "valid_edges", "grad_rows_read", "vec", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_call", "library", "k2_launches_per_call",
            "cuda_launches_per_call")} for label, r in k2g.items()}
        | {label: {key: r["backward"][key] for key in (
            "e", "d", "n", "valid_edges", "grad_rows_read", "vec", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_call", "library")} for label, r in k2n.items()
            if "backward" in r}
        | {label: {key: r["backward"][key] for key in (
            "e", "d", "n", "valid_edges", "grad_rows_read", "vec", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_call", "library", "cuda_launches_per_call")}
            for label, r in k2m.items() if "backward" in r},
        "cells": cells_kernel_entry(cl, "segment_sum_backward"),
        "examples": examples_kernel_entry(ex, "k2_grad"),
    }, {
        "name": "flash_attention", "route": "cuda", "source": K3_CUDA_SOURCE,
        "replaces": K3_TPU_KERNEL,
        "launches": lm_k3 + moe_k3 + cl_k["k3"] + ex_k["k3"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in [*k3.values(), *k3m.values()]),
        "ms": k3["prefill"]["ms"], "plain_ms": k3["prefill"]["plain_ms"],
        "bound_ms": k3["prefill"]["bound_ms"],
        "bound_by": k3["prefill"]["bound_by"],
        "library_ms": k3["prefill"]["library_ms"],
        "library_call": k3["prefill"]["library_call"],
        "shape": "bf16 q[8,15,1024,64] k/v[8,5,1024,64] causal (prefill)",
        "design": k3["prefill"]["design"],
        "decode": {key: k3["decode"][key] for key in (
            "design", "nsplit", "cuda_launches_per_call", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_call",
            "max_abs_err")},
        "designs": {kind: {key: r[key] for key in (
            "design", "dtype", "nsplit", "cuda_launches_per_call", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_call", "max_abs_err")} for kind, r in k3.items()},
        "moe": {kind: {key: r[key] for key in (
            "design", "dtype", "b", "hq", "hkv", "sq", "kv_len", "dh",
            "nsplit", "cuda_launches_per_call", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_call", "max_abs_err")}
            for kind, r in k3m.items()},
        "cells": cells_kernel_entry(cl, "flash_attention"),
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
