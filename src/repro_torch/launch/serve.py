"""Serving entry point of the port, on the GPU: batched LM decode
(prefill + greedy decode against a KV cache), DIN CTR scoring, online
GNN inference over the random-access graph query engine, and multi-hop
graph traversals (k-hop / BFS visit / shortest path) over the same
engine, optionally sharded and with the device-resident hot-set tier.

    python -m repro_torch.launch.serve --arch smollm-360m --reduced --tokens 32
    python -m repro_torch.launch.serve --arch smollm-360m --batch 8 \\
        --prompt-len 1024 --tokens 64
    python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --batch 8 \\
        --prompt-len 1024 --tokens 64
    python -m repro_torch.launch.serve --arch din --reduced --device cpu --requests 4
    python -m repro_torch.launch.serve --arch din --batch 512 --requests 64
    python -m repro_torch.launch.serve --arch gcn-cora --reduced --requests 8
    python -m repro_torch.launch.serve --arch gcn-cora --requests 8 \\
        --batch 1024 --scale 18 --edge-factor 16 --trace-sample 4
    python -m repro_torch.launch.serve --arch pna --requests 8 \\
        --batch 1024 --scale 18 --edge-factor 16
    python -m repro_torch.launch.serve --arch gcn-cora --reduced \\
        --traversal --requests 32 --batch 8 --shards 2 --replication 2 \\
        --hotset-bytes 1048576

``--device cpu`` runs it on the CPU (the kernels' plain versions).  LM
serving takes the dense and the MoE LMs.  GNN serving takes
``gcn-cora`` and ``pna``; the served batch carries none of
MeshGraphNet's or DimeNet's fields, so those exit saying which.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_arch

log = logging.getLogger("repro_torch.serve")


def serve_lm(cfg, *, batch: int, prompt_len: int, n_tokens: int,
             device=None, params: dict = None, prompts=None,
             keep_logits: bool = False):
    """Batched greedy LM serving: one prefill of ``batch`` prompts of
    ``prompt_len`` tokens, then ``n_tokens - 1`` decode steps against the
    KV cache (``max_len = prompt_len + n_tokens``), under
    ``torch.inference_mode()``; logs the JAX package's ``serve_lm`` line.

    Keywords the JAX package lacks: ``device`` (None = the GPU, raises
    without one), ``params`` (None = random weights from a
    ``torch.Generator`` seeded 0 on ``device``; pass converted weights to
    serve the reference's model), ``prompts`` (None = drawn from
    ``np.random.default_rng(0)`` as the JAX package draws them) and
    ``keep_logits``.  Returns ``(tokens, timings)``: the greedy tokens as
    int64 numpy ``[batch, n_tokens]`` (the prefill's first) and a dict of
    ``prefill_s``, ``decode_s``, ``decode_steps`` and ``tokens_per_s``
    (decode tokens over ``decode_s``), each timed on the host clock
    around work that ends in a device synchronise; with ``keep_logits``
    also ``logits``, every step's last-position logits as f32 numpy
    ``[n_tokens, batch, vocab]`` (copied after the timed loop).
    """
    from repro_torch.kernels.utils import resolve_device
    from repro_torch.models import transformer as tf

    device = resolve_device(device)
    if params is None:
        params = tf.init_params(
            cfg, torch.Generator(device=device).manual_seed(0))
    if prompts is None:
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab, (batch, prompt_len))
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                              device=device)
    if tuple(prompts.shape) != (batch, prompt_len):
        raise ValueError(f"prompts {tuple(prompts.shape)} != "
                         f"({batch}, {prompt_len})")
    max_len = prompt_len + n_tokens

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        logits, cache = tf.prefill(params, prompts, cfg, max_len=max_len)
        sync()
        t_prefill = time.perf_counter() - t0
        toks = logits.argmax(-1)[:, None]
        outs, kept = [toks], [logits]
        t0 = time.perf_counter()
        for _ in range(n_tokens - 1):
            logits, cache = tf.decode_step(params, toks, cache, cfg)
            toks = logits.argmax(-1)[:, None]
            outs.append(toks)
            if keep_logits:
                kept.append(logits)
        sync()
        t_decode = time.perf_counter() - t0
        tokens = torch.cat(outs, dim=1).cpu().numpy()
        timings = {"prefill_s": t_prefill, "decode_s": t_decode,
                   "decode_steps": n_tokens - 1,
                   "tokens_per_s": batch * (n_tokens - 1) / max(t_decode,
                                                                1e-9)}
        if keep_logits:
            timings["logits"] = torch.stack(kept).float().cpu().numpy()
    log.info("prefill %.1f ms (%d x %d); decode %.2f ms/token/batch "
             "(%.0f tok/s)", t_prefill * 1e3, batch, prompt_len,
             t_decode / max(1, n_tokens - 1) * 1e3, timings["tokens_per_s"])
    return tokens, timings


def serve_din(cfg, *, batch: int, n_requests: int, device=None,
              params: dict = None):
    """DIN CTR scoring: ``n_requests`` batches of ``batch`` (user history,
    candidate) pairs drawn from ``np.random.default_rng(0)`` in the JAX
    package's order, each scored by one eager forward under
    ``torch.inference_mode()``; logs the JAX package's ``serve_din`` line
    over requests 2..n (the first is dropped, as the JAX package drops
    its compile).

    Keywords the JAX package lacks: ``device`` (None = the GPU, raises
    without one) and ``params`` (None = random weights from a
    ``torch.Generator`` seeded 0 on ``device``).  Returns ``(logits,
    timings)``: every request's logits as f32 numpy ``[n_requests,
    batch]`` (copied after the timed loop) and a dict of
    ``latencies_s`` (every request, host clock from the batch on the
    device to a synchronise after its forward), ``p50_ms`` and
    ``p99_ms`` (requests 2..n).
    """
    from repro_torch.kernels.utils import resolve_device
    from repro_torch.models.recsys import din as m_din

    device = resolve_device(device)
    if params is None:
        params = m_din.init_params(
            cfg, torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def t(a):
        return torch.as_tensor(a, dtype=torch.int64).to(device)

    lat, outs = [], []
    with torch.inference_mode():
        for _ in range(n_requests):
            b = {
                "hist_items": t(rng.integers(-1, cfg.n_items,
                                             (batch, cfg.seq_len))),
                "hist_cates": t(rng.integers(0, cfg.n_cates,
                                             (batch, cfg.seq_len))),
                "cand_item": t(rng.integers(0, cfg.n_items, batch)),
                "cand_cate": t(rng.integers(0, cfg.n_cates, batch)),
            }
            sync()
            t0 = time.perf_counter()
            outs.append(m_din.forward(params, b, cfg))
            sync()
            lat.append(time.perf_counter() - t0)
        logits = torch.stack(outs).float().cpu().numpy()
    lat_ms = np.array(lat[1:]) * 1e3  # drop the first request
    timings = {"latencies_s": lat,
               "p50_ms": float(np.percentile(lat_ms, 50)),
               "p99_ms": float(np.percentile(lat_ms, 99))}
    log.info("DIN batch=%d: p50 %.2f ms p99 %.2f ms (%d reqs)",
             batch, timings["p50_ms"], timings["p99_ms"], len(lat_ms))
    return logits, timings


def collect_service_metrics(service) -> "MetricsRegistry":
    """Fold every stats surface a serving stack exposes into one
    :class:`repro_torch.obs.metrics.MetricsRegistry` — the
    ``--metrics-json`` snapshot and the Prometheus text both render from
    this.

    ``service`` is duck-typed as in the JAX package: ``as_dict()`` with
    ``traversal`` and ``query`` (and optionally ``hotset``) sections, and
    an ``engine`` that is either one engine (its mount's ``pgfuse.*`` is
    folded in) or a sharded service with a ``router`` and ``replicas``.
    """
    from repro_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    d = service.as_dict()
    reg.register_stats("traversal", d["traversal"])
    reg.register_stats("query", d["query"])
    if "hotset" in d:
        reg.register_stats("hotset", d["hotset"])
    backend = service.engine
    if hasattr(backend, "router"):          # a sharded service
        reg.register_stats("router", backend.router.as_dict())
        for row in backend.replicas:
            for rep in row:
                pg = rep.graph.pgfuse_stats()
                if pg is not None:
                    reg.register_stats("pgfuse", pg.as_dict())
    else:
        pg = backend.graph.pgfuse_stats()
        if pg is not None:
            reg.register_stats("pgfuse", pg.as_dict())
    return reg


def _emit_metrics(reg, tracer, metrics_json) -> None:
    """Shared exposition tail: log Prometheus text + the per-tier
    bottleneck report for any sampled traces, then persist the JSON
    snapshot when ``--metrics-json`` asked for one."""
    from repro_torch.obs.report import render_report

    if tracer is not None:
        traces = tracer.drain()
        reg.set("obs.sampled_traces", len(traces))
        reg.set("obs.dropped_traces", tracer.dropped_traces)
        if traces:
            log.info("trace report (%d sampled requests):\n%s",
                     len(traces), render_report(traces))
    log.info("metrics snapshot:\n%s", reg.to_prometheus())
    if metrics_json:
        reg.write_json(metrics_json)
        log.info("wrote metrics snapshot to %s", metrics_json)


def make_gnn_server(arch_id: str, cfg, workdir: str, *,
                    fanouts=(5, 5), use_pgfuse: bool = True,
                    seed: int = 0, decode: str = "auto",
                    fs=None, engine_name: str = None,
                    engine_budget: int = None,
                    hotset_bytes: int = None,
                    tracer=None,
                    device=None, params: dict = None,
                    scale: int = 10, edge_factor: int = 8):
    """Build the end-to-end GNN inference server over CompBin storage.

    Returns ``(answer, engine, close)``: ``answer(vertex_ids)`` runs one
    request batch — k-hop fanout sample through the
    :class:`repro_torch.query.NeighborQueryEngine` (deduplicated,
    coalesced random access; ``decode`` places eq. (1) per micro-batch —
    "auto" routes large fanouts to the CUDA decode kernel), feature
    gather from the column-family store on the SAME PG-Fuse mount, one
    transfer of the whole batch to the device
    (``data_gnn.sampled_store_batch``, split in its host half and
    ``device_batch`` so the two can be timed apart), the model's forward
    (GCN or PNA; its segment sums on the segment-sum kernel) under
    ``torch.inference_mode()`` — and returns
    the seeds' logits as a numpy array.  The mount runs the random-access
    policy (:func:`repro_torch.core.policy.choose_access_mode`).  The
    sampler is seeded, so a given request stream is reproducible.

    Multi-tenant: pass ``fs=`` (a shared
    :class:`repro_torch.core.pgfuse.PGFuseFS` mount) plus
    ``engine_name`` / ``engine_budget`` and this server's files join ONE
    :class:`~repro_torch.core.pgfuse.EngineShare`.

    Keywords the JAX package lacks: ``device`` (None = the GPU, raises
    without one), ``params`` (None = random weights from a
    ``torch.Generator`` seeded 0; pass converted weights to serve the
    reference's model) and ``scale`` / ``edge_factor`` of the served
    graph (the JAX package always serves ``rmat(10, 8)``).  With a
    ``tracer``, each request is a ``gnn.request`` span whose children
    split its time into the tiers ``sample`` (with the engine's own
    spans below it), ``features``, ``h2d`` and ``compute``.

    ``hotset_bytes`` adds the device-resident hot-set tier
    (:class:`repro_torch.query.HotSetCache`, sized by
    :func:`repro_torch.core.policy.choose_hotset_admission`, its runs on
    ``device``): hub neighborhoods are answered from resident decoded
    runs and skip the packed-byte path entirely, byte-identically.
    """
    from repro_torch.core import featstore, paragrapher, policy
    from repro_torch.graph import NeighborSampler
    from repro_torch.kernels.utils import resolve_device
    from repro_torch.launch.data_gnn import (device_batch, ensure_gnn_assets,
                                             refuse_unbuilt_fields,
                                             sampled_host_batch)
    from repro_torch.launch.steps import _GNN_MODULES
    from repro_torch.obs.trace import NULL_TRACER
    from repro_torch.query import NeighborQueryEngine

    refuse_unbuilt_fields(arch_id, "serving")
    device = resolve_device(device)
    d_in = getattr(cfg, "d_in", getattr(cfg, "d_node_in", 16))
    n_classes = getattr(cfg, "n_classes", 7)
    block_size = 1 << 16
    gp, fp, _ = ensure_gnn_assets(workdir, d_in, n_classes, scale=scale,
                                  edge_factor=edge_factor,
                                  block_size=block_size)
    amode = policy.choose_access_mode("serve")
    budget = engine_budget if engine_budget is not None else 256 * block_size
    share = None
    if fs is not None:
        share = fs.register_engine(
            engine_name or f"{arch_id}:{os.path.abspath(workdir)}", budget)
        g = paragrapher.open_graph(
            gp, pgfuse_fs=fs, pgfuse_readahead=amode.readahead,
            pgfuse_engine=share)
    else:
        g = paragrapher.open_graph(
            gp, use_pgfuse=use_pgfuse, pgfuse_block_size=block_size,
            pgfuse_readahead=amode.readahead, pgfuse_eviction=amode.eviction,
            pgfuse_max_resident_bytes=budget if use_pgfuse else None)
    churn_cap = (int(amode.churn_budget_fraction * budget)
                 if amode.churn_budget_fraction else None)
    feats = engine = None
    try:
        feats = featstore.open_featstore(fp, fs=g.fs,
                                         pgfuse_file_budget=churn_cap,
                                         pgfuse_file_readahead=0,
                                         pgfuse_engine=share)
        engine = NeighborQueryEngine(g, decode=decode, hotset=hotset_bytes,
                                     tracer=tracer, device=device)
    except BaseException:
        if feats is not None:
            feats.close()
        g.close()
        raise
    sampler = NeighborSampler(engine, fanouts=fanouts, seed=seed)
    mod = _GNN_MODULES[arch_id]
    if params is None:
        gen = torch.Generator().manual_seed(0)
        params = mod.init_params(cfg, gen, device=device)
    else:
        params = {k: v.to(device) for k, v in params.items()}
    spans = tracer if tracer is not None else NULL_TRACER
    sync = (tracer is not None and device.type == "cuda")

    def answer(vertex_ids) -> np.ndarray:
        """One inference request batch: logits for ``vertex_ids``."""
        with spans.span("gnn.request", tier="request"):
            with spans.span("gnn.sample", tier="sample"):
                block = sampler.sample(np.asarray(vertex_ids, dtype=np.int64))
            with spans.span("gnn.features", tier="features"):
                host = sampled_host_batch(arch_id, cfg, block, feats)
            with spans.span("gnn.h2d", tier="h2d") as sp:
                batch = device_batch(host, device)
                if sync:    # charge the copy to this tier, not the next
                    torch.cuda.current_stream(device).synchronize()
                sp.set(bytes=int(sum(v.nbytes for v in host.values())))
            with spans.span("gnn.forward", tier="compute"):
                with torch.inference_mode():
                    logits = mod.forward(params, batch, cfg)
                    return logits[:len(block.seeds)].cpu().numpy()

    def close() -> None:
        # both handles hold refcounted retains on the (possibly shared)
        # mount: each close releases its own file
        engine.close()
        feats.close()
        g.close()

    return answer, engine, close


def serve_gnn(arch_id: str, cfg, *, batch: int, n_requests: int,
              workdir: str, hotset_bytes: int = None,
              metrics_json: str = None, trace_sample: int = 0,
              device=None, scale: int = 10, edge_factor: int = 8) -> None:
    """Synthetic user-inference traffic against :func:`make_gnn_server`.

    Requests draw vertices zipf-style (a hot head, like real user
    traffic), so consecutive batches share neighborhoods — the dedup
    ratio and cache hit rate below are the quantities the engine exists
    to maximize.
    """
    from repro_torch.obs import Tracer

    tracer = Tracer(sample_every=trace_sample) if trace_sample else None
    answer, engine, close = make_gnn_server(
        arch_id, cfg, workdir, hotset_bytes=hotset_bytes, tracer=tracer,
        device=device, scale=scale, edge_factor=edge_factor)
    try:
        n = engine.n_vertices
        rng = np.random.default_rng(0)
        lat = []
        for _ in range(n_requests):
            # zipf-ish: half the traffic hits the top ~1/16 of vertices
            hot = rng.integers(0, max(1, n // 16), batch)
            cold = rng.integers(0, n, batch)
            seeds = np.where(rng.random(batch) < 0.5, hot, cold)
            t0 = time.perf_counter()
            logits = answer(seeds)
            lat.append(time.perf_counter() - t0)
            assert logits.shape[0] == batch
        lat_ms = np.array(lat[1:] or lat) * 1e3  # drop the warm-up request
        st = engine.stats
        pg = engine.graph.pgfuse_stats()
        hit = (pg.cache_hits / max(1, pg.cache_hits + pg.cache_misses)
               if pg else 0.0)
        log.info("GNN serve batch=%d: p50 %.2f ms p99 %.2f ms (%d reqs); "
                 "query dedup %.2fx, %d blocks touched, %d coalesced "
                 "reads, cache hit rate %.2f; %d/%d batches device-"
                 "decoded (%.1f KiB H2D), window closes %s",
                 batch, np.percentile(lat_ms, 50), np.percentile(lat_ms, 99),
                 len(lat_ms),
                 st.dedup_ratio, st.blocks_touched, st.coalesced_reads, hit,
                 st.device_batches, st.batches, st.bytes_h2d / 1024,
                 st.close_reasons)
        if engine.hotset is not None:
            _log_hotset(engine.hotset.stats.as_dict())
        if metrics_json or tracer is not None:
            from repro_torch.obs.metrics import MetricsRegistry
            reg = MetricsRegistry()
            reg.register_stats("query", st.as_dict())
            if pg is not None:
                reg.register_stats("pgfuse", pg.as_dict())
            if engine.hotset is not None:
                reg.register_stats("hotset", engine.hotset.stats.as_dict())
            _emit_metrics(reg, tracer, metrics_json)
    finally:
        close()


def _log_hotset(hs: dict) -> None:
    log.info("hot set: hit rate %.2f (%d/%d lookups), "
             "%d resident entries (%.1f KiB), %d pinned",
             hs["hit_rate"], hs["hits"], hs["lookups"],
             hs["resident_entries"], hs["resident_bytes"] / 1024,
             hs["pinned"])


def make_traversal_server(workdir: str = None, *, decode: str = "auto",
                          slo_s: float = 0.5,
                          edge_budget: int = 1 << 16,
                          service_edges_per_s: float = 5.0e6,
                          servers: int = 2, seed: int = 1,
                          shards: int = 1, replication: int = 1,
                          hotset_bytes: int = None,
                          tracer=None, device=None, path: str = None):
    """The traversal request type next to GNN inference: a
    :class:`repro_torch.query.TraversalService` over the SAME CompBin
    bytes (and the same random-access PG-Fuse policy) the inference server
    reads.  Returns ``(service, close)``; answer requests with
    ``service.khop(...)`` / ``service.bfs_visit(...)`` /
    ``service.shortest_path(...)``, ``service.request(req)`` or
    ``service.submit(req)`` (executor threads, each calling the engine).

    The admission gate is sized by
    :func:`repro_torch.core.policy.choose_admission` from the latency SLO
    and the per-request edge budget — overload sheds immediately
    (:class:`repro_torch.query.TraversalShed`) instead of queueing into
    SLO violations.

    ``shards > 1`` (or ``replication > 1``) scales out: the frontier
    backend becomes a :class:`repro_torch.query.ShardedQueryService` with
    ``shards`` vertex-range shards x ``replication`` replicas, each with
    its own engine and PG-Fuse mount (all on the one card), and the
    admission gate is re-sized for the scaled aggregate service rate
    (``service_edges_per_s * shards`` across ``servers * shards``
    executors).  Traversal answers stay byte-identical to ``shards=1``.
    ``hotset_bytes`` gives each engine (the single backend, or every shard
    replica) a hot-set tier of that byte budget.

    Keywords the JAX package lacks: ``device`` (None = the GPU, raises
    without one; every engine and hot set of the server runs there) and
    ``path`` (serve this existing CompBin file; ``workdir`` is then
    unused — the JAX package always serves ``ensure_gnn_assets``'
    ``rmat(10, 8)`` in ``workdir``).
    """
    from repro_torch.core import paragrapher, policy
    from repro_torch.kernels.utils import resolve_device
    from repro_torch.launch.data_gnn import ensure_gnn_assets
    from repro_torch.query import (NeighborQueryEngine, ShardedQueryService,
                                   TraversalService)

    device = resolve_device(device)
    block_size = 1 << 16
    if path is not None:
        gp = path
    else:
        gp, _, _ = ensure_gnn_assets(workdir, 16, 7, block_size=block_size,
                                     seed=seed)
    amode = policy.choose_access_mode("serve")
    g = engine = None
    if shards > 1 or replication > 1:
        # each shard replica mounts its own cache slice of the same
        # budget one mount would have had (the locality the split buys)
        backend = ShardedQueryService(
            gp, n_shards=shards, replication=replication, decode=decode,
            hotset_bytes=hotset_bytes, tracer=tracer,
            open_kwargs=dict(
                pgfuse_block_size=block_size,
                pgfuse_max_resident_bytes=max(
                    block_size, 256 * block_size // max(1, shards))),
            engine_kwargs=dict(device=device))
        plan = policy.choose_admission(
            slo_s, edge_budget=edge_budget,
            service_edges_per_s=service_edges_per_s * shards,
            servers=servers * shards)
    else:
        g = paragrapher.open_graph(
            gp, use_pgfuse=True, pgfuse_block_size=block_size,
            pgfuse_readahead=amode.readahead, pgfuse_eviction=amode.eviction,
            pgfuse_max_resident_bytes=256 * block_size)
        try:
            engine = NeighborQueryEngine(g, decode=decode,
                                         hotset=hotset_bytes, tracer=tracer,
                                         device=device)
        except BaseException:
            g.close()
            raise
        backend = engine
        plan = policy.choose_admission(
            slo_s, edge_budget=edge_budget,
            service_edges_per_s=service_edges_per_s, servers=servers)
    service = TraversalService(backend, admission=plan,
                               default_max_edges=edge_budget,
                               tracer=tracer)

    def close() -> None:
        service.close()
        if engine is not None:
            engine.close()
            g.close()
        else:
            backend.close()

    return service, close


def traversal_mix(n_vertices: int, n_requests: int, batch: int, *,
                  max_edges: int, seed: int = 0):
    """The synthetic traversal traffic :func:`serve_traversal` sends, as
    a generator of :class:`repro_torch.query.TraversalRequest`: request
    ``i`` draws ``batch`` seeds, half of them from the low-id hub range
    ``[0, n/16)``, and asks ``khop(seeds, k=2)`` (``i % 3 == 0``),
    ``bfs_visit(seeds[:1], max_vertices=4*batch)`` (``1``) or
    ``shortest_path(seeds[0], seeds[1])`` (``2``), each under
    ``max_edges`` — the JAX package's mix, draw for draw."""
    from repro_torch.query import TraversalRequest

    rng = np.random.default_rng(seed)
    for i in range(n_requests):
        hot = rng.integers(0, max(1, n_vertices // 16), batch)
        cold = rng.integers(0, n_vertices, batch)
        seeds = np.where(rng.random(batch) < 0.5, hot, cold)
        if i % 3 == 0:
            yield TraversalRequest("khop", seeds, k=2, max_edges=max_edges)
        elif i % 3 == 1:
            yield TraversalRequest("bfs", seeds[:1], max_edges=max_edges,
                                   max_vertices=4 * batch)
        else:
            yield TraversalRequest("path", [int(seeds[0])],
                                   target=int(seeds[1]),
                                   max_edges=max_edges)


def serve_traversal(*, n_requests: int, batch: int, workdir: str = None,
                    shards: int = 1, replication: int = 1,
                    hotset_bytes: int = None,
                    metrics_json: str = None,
                    trace_sample: int = 0, device=None,
                    path: str = None) -> dict:
    """Synthetic zipf traversal traffic (:func:`traversal_mix`) against
    :func:`make_traversal_server`: k-hop neighborhoods, bounded BFS
    visits and shortest paths over hub-biased seeds, one request at a
    time.

    ``trace_sample=N`` turns on span tracing for every Nth request
    (:class:`repro_torch.obs.Tracer`); the per-tier attribution report is
    logged on exit.  ``metrics_json`` persists the folded
    :func:`collect_service_metrics` snapshot there on exit.  Returns
    ``service.as_dict()`` taken before the server closes (the JAX package
    returns None)."""
    from repro_torch.obs import Tracer
    from repro_torch.query import TraversalShed

    tracer = Tracer(sample_every=trace_sample) if trace_sample else None
    service, close = make_traversal_server(workdir, shards=shards,
                                           replication=replication,
                                           hotset_bytes=hotset_bytes,
                                           tracer=tracer, device=device,
                                           path=path)
    try:
        t0 = time.perf_counter()
        shed = 0
        for req in traversal_mix(service.n_vertices, n_requests, batch,
                                 max_edges=service.default_max_edges):
            try:
                service.request(req)
            except TraversalShed:
                shed += 1
        wall = time.perf_counter() - t0
        st = service.stats
        qs = service.engine.stats
        log.info("traversal serve: %d reqs in %.2fs (%.0f req/s); "
                 "p50 %.3f ms p99 %.3f ms, shed %d (%.1f%%); "
                 "%d frontier batches, %d edges scanned, "
                 "engine dedup %.2fx, %d/%d device batches",
                 st.completed, wall, st.completed / max(wall, 1e-9),
                 st.p50_s * 1e3, st.p99_s * 1e3, shed,
                 100 * st.shed_rate, st.frontier_batches,
                 st.edges_scanned, qs.dedup_ratio, qs.device_batches,
                 qs.batches)
        d = service.as_dict()
        if d.get("hotset"):
            _log_hotset(d["hotset"])
        if metrics_json or tracer is not None:
            _emit_metrics(collect_service_metrics(service), tracer,
                          metrics_json)
        return d
    finally:
        close()


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--workdir", default="/tmp/repro_torch_serve")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--scale", type=int, default=10,
                    help="RMAT scale of the served graph (2^scale vertices)")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--traversal", action="store_true",
                    help="serve multi-hop traversal requests (k-hop / "
                         "BFS visit / shortest path) over the graph "
                         "assets instead of model inference")
    ap.add_argument("--shards", type=int, default=1,
                    help="vertex-range shards for --traversal serving "
                         "(each with its own engine and PG-Fuse mount; "
                         "answers stay byte-identical)")
    ap.add_argument("--replication", type=int, default=1,
                    help="replicas per shard for --traversal serving "
                         "(round-robin load balancing + failover)")
    ap.add_argument("--hotset-bytes", type=int, default=None,
                    help="byte budget for the device-resident hot-set "
                         "tier of decoded hub runs (gnn/traversal "
                         "serving; default: no hot set)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write a JSON metrics snapshot on exit")
    ap.add_argument("--trace-sample", type=int, default=0, metavar="N",
                    help="span-trace every Nth request and log the "
                         "per-tier attribution report on exit (0: off)")
    args = ap.parse_args(argv)

    try:
        spec = get_arch(args.arch)
    except KeyError as e:
        raise SystemExit(e.args[0]) from None
    cfg = spec.make_reduced() if args.reduced else spec.make_config()
    if args.traversal:
        if spec.family != "gnn":
            raise SystemExit("--traversal serves graph requests; pick a "
                             "gnn arch for its graph assets")
        serve_traversal(n_requests=args.requests, batch=args.batch,
                        workdir=args.workdir, shards=args.shards,
                        replication=args.replication,
                        hotset_bytes=args.hotset_bytes,
                        metrics_json=args.metrics_json,
                        trace_sample=args.trace_sample, device=args.device)
        return
    if spec.family == "lm":
        serve_lm(cfg, batch=args.batch, prompt_len=args.prompt_len,
                 n_tokens=args.tokens, device=args.device)
        return
    if spec.family == "recsys":
        serve_din(cfg, batch=args.batch, n_requests=args.requests,
                  device=args.device)
        return
    serve_gnn(args.arch, cfg, batch=args.batch, n_requests=args.requests,
              workdir=args.workdir, hotset_bytes=args.hotset_bytes,
              metrics_json=args.metrics_json,
              trace_sample=args.trace_sample, device=args.device,
              scale=args.scale, edge_factor=args.edge_factor)


if __name__ == "__main__":
    main()
