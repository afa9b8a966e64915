#!/usr/bin/env python3
"""On-GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper card::

    python3 chip_smoke.py            # full size (load phase at --scale 23)

It builds every CUDA kernel from ``src/repro_torch/csrc`` with ``nvcc``,
holds each kernel against its plain PyTorch version on the card (the
decode bit for bit, the segment sum to f32 rounding, flash attention's
three designs -- tensor-core prefill, split decode, f32 FMA -- to the JAX
package's kernel tolerances), drives the port's main paths
through the library entry points -- load a CompBin graph into HBM
through PG-Fuse, answer batches of neighbor queries from the same file,
serve GCN inference requests at gcn-cora's full width (sample through
the query engine, gather feature rows from the feature store, one
transfer, forward pass with the segment-sum kernel), and serve
smollm-360m at full width and depth (prefill + greedy decode against a
KV cache, every attention on the flash-attention kernel; then again in
bf16 with every attention call held to f64) -- checks every result
against an independent plain computation, and prints what it measured.

Output contract: the line before the last but one is the card's name and
power limit as ``nvidia-smi`` gives them; the last but one is one JSON
object ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed phase raises, so the exit code is non-zero and no result line
is printed.  Without a CUDA device it exits with code 2 at once.

The load/serve/LogCSR/GNN phases are plain functions of ``device`` and
``scale``, the LM phases of ``(device, cfg, batch, prompt_len,
n_tokens)``, so the CPU tests run the same code at a small size.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

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
from repro_torch.kernels.flash_attention import (attention_bshd,  # noqa: E402
                                                 attention_ref,
                                                 flash_attention, plan)
from repro_torch.kernels.segment_sum import (segment_sum,  # noqa: E402
                                             segment_sum_ref)
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
#: tokens of the served-dtype run whose every attention call is held to
#: f64 (1 prefill + 3 decode steps: both of K3's bf16 designs)
LM_SHADOW_TOKENS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phases 4-6: the main path, as functions of (device, scale)
# ---------------------------------------------------------------------------

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
    tiers: dict = {}
    for root in tracer.drain():
        for tier, sec in tier_times(root).items():
            tiers[tier] = tiers.get(tier, 0.0) + sec / max(1, n_traced)
    launched = compbin_decode.launches - launches0
    assert launched == (launched_device + want_device + n_traced
                        if on_gpu else 0)
    lat_sorted = sorted(lat)
    return {"batches": qs["batches"], "device_batches": qs["device_batches"],
            "requests": qs["requests"], "edges_returned": qs["edges_returned"],
            "bytes_h2d": qs["bytes_h2d"], "close_reasons": qs["close_reasons"],
            "auto_device_batches": auto["device_batches"],
            "auto_batches": auto["batches"], "ids_checked": checked,
            "tier_s_per_traced_batch": tiers,
            "p50_s": lat_sorted[len(lat) // 2],
            "p99_s": lat_sorted[min(len(lat) - 1, int(0.99 * len(lat)))],
            "launches": launched}


def phase_logcsr(device, scale: int, workdir: str, *, n_batches: int = 8,
                 batch: int = 256) -> dict:
    """The same load and serve over a LogCSR file: its neighbors share
    CompBin's packed layout, so the same kernel decodes them."""
    csr, path, _, _ = make_graph(scale, workdir, "logcsr", seed=3)
    load = phase_load(csr, path, device)
    serve = phase_serve(csr, path, device, n_batches=n_batches, batch=batch,
                        n_async=2, n_auto=2, seed=4)
    return {"load": load, "serve": serve}


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
                     seed: int, requests: list):
    """The plain CPU path the served logits are held against: an
    in-memory CSR sampler with the server's seed, feature rows read
    straight out of the store file (``np.memmap``, no PG-Fuse, no
    gather), and the GCN forward on CPU tensors.  Yields (logits, block
    edge_dst, block node count) per request."""
    from repro_torch.core import featstore
    from repro_torch.graph import NeighborSampler
    from repro_torch.launch.data_gnn import block_to_edges
    from repro_torch.models.gnn import gcn

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
            logits = gcn.forward(params, batch, cfg)[:len(seeds)].numpy()
        yield logits, dst.astype(np.int32), n


def phase_gnn(device, workdir: str, *, scale: int = 18,
              edge_factor: int = 16, reduced: bool = False,
              n_requests: int = 8, batch: int = 1024,
              fanouts=(5, 5), seed: int = 0) -> dict:
    """GCN inference serving from CompBin through the port's
    ``make_gnn_server`` (gcn-cora, full width unless ``reduced``):
    ``n_requests`` zipf-drawn batches of ``batch`` seeds, every request
    span-traced, every request's logits held against the plain CPU path
    on the same block (:func:`gnn_plain_logits`) at ``GNN_TOL``."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.data_gnn import ensure_gnn_assets
    from repro_torch.launch.serve import make_gnn_server
    from repro_torch.models.gnn import gcn

    on_gpu = torch.device(device).type == "cuda"
    spec = get_arch("gcn-cora")
    cfg = spec.make_reduced() if reduced else spec.make_config()
    t0 = time.perf_counter()
    gp, fp, _ = ensure_gnn_assets(workdir, cfg.d_in, cfg.n_classes,
                                  scale=scale, edge_factor=edge_factor)
    assets_s = time.perf_counter() - t0
    params = gcn.init_params(cfg, torch.Generator().manual_seed(seed))
    k1_0, k2_0 = compbin_decode.launches, segment_sum.launches
    tracer = Tracer()
    answer, engine, close = make_gnn_server(
        "gcn-cora", cfg, workdir, fanouts=fanouts, seed=seed, decode="auto",
        device=device, params=params, scale=scale, edge_factor=edge_factor,
        tracer=tracer)
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
    k1, k2 = compbin_decode.launches - k1_0, segment_sum.launches - k2_0
    tiers: dict = {}
    traces = tracer.drain()
    assert len(traces) == n_requests, len(traces)
    for root in traces:
        for tier, sec in tier_times(root).items():
            tiers[tier] = tiers.get(tier, 0.0) + sec / n_requests
    worst = 0.0
    for got, (want, dst, n_nodes) in zip(
            served, gnn_plain_logits(gp, fp, cfg, params, fanouts, seed,
                                     requests)):
        assert got.shape == want.shape == (batch, cfg.n_classes), got.shape
        assert np.isfinite(got).all(), "non-finite logits"
        worst = max(worst, float(np.abs(got - want).max()))
        assert np.allclose(got, want, rtol=GNN_TOL, atol=GNN_TOL), \
            f"served logits differ from the plain path (max {worst})"
    # one launch for the degrees, one per layer's aggregation
    assert k2 == ((cfg.n_layers + 1) * n_requests if on_gpu else 0), k2
    if on_gpu:
        assert k1 > 0 and qs["device_batches"] > 0, (k1, qs)
    else:
        assert k1 == 0
    steady = sorted(lat[1:] or lat)
    return {"arch": cfg.name, "d_in": cfg.d_in, "d_hidden": cfg.d_hidden,
            "n_classes": cfg.n_classes, "scale": scale,
            "edge_factor": edge_factor, "vertices": n_vertices,
            "file_bytes": file_bytes, "assets_s": assets_s,
            "requests": n_requests, "batch": batch,
            "fanouts": list(fanouts), "nodes_per_request": n_nodes,
            "edge_slots_per_request": int(dst.size),
            "valid_edges_last_request": int((dst >= 0).sum()),
            "feature_bytes_per_request": n_nodes * cfg.d_in * 4,
            "latency_s": lat, "p50_s": steady[len(steady) // 2],
            "p99_s": steady[min(len(steady) - 1, int(0.99 * len(steady)))],
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


def lm_device_split(cfg, params, batch: int, prompt_len: int,
                    n_decode: int) -> dict:
    """Where one prefill and ``n_decode`` decode steps spend the card's
    time: ``torch.profiler`` device time summed by kernel class (K3,
    GEMM, copies, other: norms, RoPE, SwiGLU, casts, argmax) against the
    host-clock wall of the same profiled work.  Only device events count
    (a host op's own entry repeats its kernels' time); with no device
    time at all the split is reported as not measured (None)."""
    from torch.profiler import ProfilerActivity, profile

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
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                work()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            sums = {"k3": 0.0, "gemm": 0.0, "copy": 0.0, "other": 0.0}
            kernels = []
            for ev in prof.key_averages():
                if ev.device_type != torch.autograd.DeviceType.CUDA:
                    continue        # a host op: its kernels are counted
                us = getattr(ev, "self_device_time_total", None)
                if us is None:
                    us = getattr(ev, "self_cuda_time_total", 0.0)
                if us:
                    sums[_kernel_class(ev.key)] += us / 1e3
                    kernels.append((us / 1e3, ev.count, ev.key[:60]))
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


def _k2_close(got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    rtol, atol = K2_TOL[dtype]
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float((got - want).abs().max()) if got.numel() else 0.0
    assert torch.allclose(got, want, rtol=rtol, atol=atol), \
        f"segment_sum kernel != plain version (max abs err {err})"
    return err


def phase_segment_sum_checks() -> int:
    """K2 vs its plain version on the card: the five shapes of the JAX
    package's sweep x {f32, bf16} with ids drawn from [-1, N), more
    segments than the TPU kernel takes (N > 8192), ids >= N, E = 0,
    N = 0, and the refusal of a tensor that requires grad."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    cases = [(64, 16, 4), (513, 200, 7), (2048, 128, 1024), (100, 1, 100),
             (1, 8, 1)]
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for e, d, n in cases + [(40000, 24, 20000)]:
            for hi in (n, n + 3):          # n + 3: ids >= N are dropped
                msgs = torch.randn(e, d, generator=gen, device="cuda"
                                   ).to(dtype)
                ids = torch.randint(-1, hi, (e,), generator=gen,
                                    device="cuda", dtype=torch.int32)
                before = segment_sum.launches
                got = segment_sum(msgs, ids, n)
                assert segment_sum.launches == before + 1
                _k2_close(got, segment_sum_ref(msgs, ids, n), dtype)
                n_cases += 1
    for e, d, n in ((0, 8, 5), (7, 8, 0), (7, 0, 5)):
        msgs = torch.randn(e, d, generator=gen, device="cuda")
        ids = torch.randint(0, max(n, 1), (e,), generator=gen,
                            device="cuda", dtype=torch.int32)
        got = segment_sum(msgs, ids, n)
        assert got.shape == (n, d) and not got.any()
        n_cases += 1
    try:
        segment_sum(torch.ones(4, 2, device="cuda", requires_grad=True),
                    torch.zeros(4, dtype=torch.int32, device="cuda"), 2)
    except RuntimeError:
        pass
    else:
        raise AssertionError("a CUDA tensor that requires grad did not raise")
    torch.cuda.synchronize()
    log(f"[kernel] segment_sum: {n_cases} cases (5 sweep shapes + N=20000, "
        f"ids in [-1,N) and [-1,N+3), f32 and bf16, E=0/N=0/D=0) within "
        f"f32 rtol/atol {K2_TOL[torch.float32]}, bf16 "
        f"{K2_TOL[torch.bfloat16]} of the plain version; requires_grad "
        f"raises")
    return n_cases


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
    """K2 at one main-path shape: random f32 messages over the served
    block's ``edge_dst``; kernel vs plain version, then kernel, plain and
    library-call times."""
    e = ids.numel()
    msgs = torch.randn(e, d, generator=gen, device="cuda")
    got = segment_sum(msgs, ids, n)
    want = segment_sum_ref(msgs, ids, n)
    torch.cuda.synchronize()
    err = _k2_close(got, want, torch.float32)
    del got, want
    ms = time_cuda(lambda: segment_sum(msgs, ids, n), flush=flush)
    plain = time_cuda(lambda: segment_sum_ref(msgs, ids, n), flush=flush)
    valid = (ids >= 0) & (ids < n)
    lib_ids, lib_msgs = ids[valid].long(), msgs[valid]
    lib = time_cuda(lambda: torch.zeros(n, d, device="cuda").index_add_(
        0, lib_ids, lib_msgs), flush=flush)
    n_valid = int(valid.sum())
    bms, by = k2_bound_ms(e, d, n, n_valid)
    return {"e": e, "d": d, "n": n, "valid_edges": n_valid,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "library_ms": lib, "bound_ms": bms, "bound_by": by,
            "bytes": k2_bytes(e, d, n, n_valid),
            "gb_per_s": k2_bytes(e, d, n, n_valid) / (ms * 1e-3) / 1e9}


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


def k3_cuda_launches(fn, attempts: int = 3) -> int | None:
    """CUDA kernels of K3 (names with ``k3_``) that one call of ``fn``
    launches, counted in a ``torch.profiler`` trace of that call.  A
    trace now and then holds no device event at all; the call is then
    traced again, up to ``attempts`` times, and None (not measured) is
    returned if no trace saw the card."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = [ev for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
        if device:
            n = sum(ev.count for ev in device if "k3_" in ev.key)
            assert n >= 1, \
                f"no K3 kernel in the trace: {[ev.key for ev in device]}"
            return n
    return None


def measure_flash(kind: str, flush, gen) -> dict:
    """K3 at one of ``K3_SHAPES`` (smollm-360m's 15 query over 5 KV heads
    of 64): the prefill as q [b,15,s,64] over k/v [b,5,s,64], causal; the
    decode step as one query row per head against ``live`` positions of
    a [b, live+1, 5, 64] cache view.  Kernel vs plain version, then
    kernel, plain and library-call times.  The library calls are
    ``scaled_dot_product_attention`` with ``enable_gqa=True`` and an
    explicit decode-convention mask and, where Sq == Skv, with
    ``is_causal=True`` (which aligns the mask top-left, the same function
    there, and may take a faster backend); ``library_ms`` is the faster
    of the two and ``library_call`` names it.  ``cuda_launches_per_call``
    is counted by the profiler around one call (:func:`k3_cuda_launches`)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sh = K3_SHAPES[kind]
    dtype, b, hq, hkv, dh = sh["dtype"], sh["b"], 15, 5, 64
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
    launches = k3_cuda_launches(kernel)
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

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=23,
                    help="RMAT scale of the load/serve graph (2^scale "
                         "vertices, 16 edges each before dedup)")
    ap.add_argument("--logcsr-scale", type=int, default=16)
    ap.add_argument("--large-log2", type=int, default=28,
                    help="log2 of the id count of the timed kernel cases")
    ap.add_argument("--gnn-scale", type=int, default=18,
                    help="RMAT scale of the graph GCN serving reads "
                         "(edge factor 16, gcn-cora's full width)")
    ap.add_argument("--gnn-requests", type=int, default=8,
                    help="GCN inference requests of 1024 seeds each")
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
    k2_cases = phase_segment_sum_checks()
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

        # phase 10: K2 at the three shapes the served block gives it
        ids = torch.from_numpy(gnn.pop("edge_dst")).to(device)
        n_nodes = gnn.pop("n_nodes")
        k2 = {}
        for label, d in (("layer0", gnn["d_in"]), ("layer1", gnn["d_hidden"]),
                         ("degree", 1)):
            r = k2[label] = measure_segment_sum(ids, d, n_nodes, flush, gen)
            log(f"[kernel] segment_sum {label} E={r['e']} "
                f"({r['valid_edges']} valid) D={r['d']} N={r['n']}: kernel "
                f"{r['ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})  {r['gb_per_s']:.1f} GB/s  plain "
                f"{r['plain_ms']:.4f} ms  library_ms (index_add_) "
                f"{r['library_ms']:.4f}  max_abs_err {r['max_abs_err']:.3g}")

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
    results.update(load=load, serve=serve, logcsr=logcsr, crossover=cross,
                   h2d=h2d, gnn=gnn, segment_sum=k2,
                   segment_sum_cases=k2_cases, flash_attention=k3,
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
        "replaces": TPU_KERNEL, "launches": main_path_launches + gnn_k1,
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
        "shape": f"uint8[{k1['n']}*{k1['b']}] -> int32[{k1['n']}]",
    }, {
        "name": "segment_sum", "route": "cuda", "source": K2_CUDA_SOURCE,
        "replaces": K2_TPU_KERNEL, "launches": gnn_k2,
        "max_abs_err": max(r["max_abs_err"] for r in k2.values()),
        "ms": k2["layer0"]["ms"], "plain_ms": k2["layer0"]["plain_ms"],
        "bound_ms": k2["layer0"]["bound_ms"],
        "bound_by": k2["layer0"]["bound_by"],
        "library_ms": k2["layer0"]["library_ms"],
        "shape": (f"f32[{k2['layer0']['e']},{k2['layer0']['d']}] by "
                  f"int32[{k2['layer0']['e']}] -> "
                  f"f32[{k2['layer0']['n']},{k2['layer0']['d']}] (layer 0)"),
    }, {
        "name": "flash_attention", "route": "cuda", "source": K3_CUDA_SOURCE,
        "replaces": K3_TPU_KERNEL, "launches": lm_k3,
        "max_abs_err": max(r["max_abs_err"] for r in k3.values()),
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
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
