"""Serving entry point of the port, on the GPU: batched LM decode
(prefill + greedy decode against a KV cache) and online GNN inference
over the random-access graph query engine.

    python -m repro_torch.launch.serve --arch smollm-360m --reduced --tokens 32
    python -m repro_torch.launch.serve --arch smollm-360m --batch 8 \\
        --prompt-len 1024 --tokens 64
    python -m repro_torch.launch.serve --arch gcn-cora --reduced --requests 8
    python -m repro_torch.launch.serve --arch gcn-cora --requests 8 \\
        --batch 1024 --scale 18 --edge-factor 16 --trace-sample 4

``--device cpu`` runs it on the CPU (the kernels' plain versions).  The
JAX package's traversal and sharded serving (``--traversal``,
``--shards``, ``--replication``), its hot-set tier (``--hotset-bytes``),
its MoE LMs and its DIN serving are not ported yet: asking for them
exits with a message saying so.
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
    ``device_batch`` so the two can be timed apart), GCN forward (its
    segment sums on the segment-sum kernel) under
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
    ``hotset_bytes`` raises ``NotImplementedError``: the hot-set tier is
    not ported yet.
    """
    from repro_torch.core import featstore, paragrapher, policy
    from repro_torch.graph import NeighborSampler
    from repro_torch.kernels.utils import resolve_device
    from repro_torch.launch.data_gnn import (device_batch, ensure_gnn_assets,
                                             sampled_host_batch)
    from repro_torch.launch.steps import _GNN_MODULES
    from repro_torch.obs.trace import NULL_TRACER
    from repro_torch.query import NeighborQueryEngine

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
        if metrics_json or tracer is not None:
            from repro_torch.obs.metrics import MetricsRegistry
            reg = MetricsRegistry()
            reg.register_stats("query", st.as_dict())
            if pg is not None:
                reg.register_stats("pgfuse", pg.as_dict())
            _emit_metrics(reg, tracer, metrics_json)
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
                    help="not ported yet (traversal serving)")
    ap.add_argument("--shards", type=int, default=1,
                    help="not ported yet (sharded serving)")
    ap.add_argument("--replication", type=int, default=1,
                    help="not ported yet (replicated serving)")
    ap.add_argument("--hotset-bytes", type=int, default=None,
                    help="not ported yet (the hot-set tier)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write a JSON metrics snapshot on exit")
    ap.add_argument("--trace-sample", type=int, default=0, metavar="N",
                    help="span-trace every Nth request and log the "
                         "per-tier attribution report on exit (0: off)")
    args = ap.parse_args(argv)

    if args.traversal or args.shards > 1 or args.replication > 1:
        raise SystemExit("--traversal / --shards / --replication: traversal "
                         "and sharded serving are not ported yet")
    try:
        spec = get_arch(args.arch)
    except KeyError as e:
        raise SystemExit(e.args[0]) from None
    cfg = spec.make_reduced() if args.reduced else spec.make_config()
    if spec.family == "lm":
        serve_lm(cfg, batch=args.batch, prompt_len=args.prompt_len,
                 n_tokens=args.tokens, device=args.device)
        return
    if spec.family != "gnn":
        raise SystemExit(f"{spec.family} serving is not ported yet")
    serve_gnn(args.arch, cfg, batch=args.batch, n_requests=args.requests,
              workdir=args.workdir, hotset_bytes=args.hotset_bytes,
              metrics_json=args.metrics_json,
              trace_sample=args.trace_sample, device=args.device,
              scale=args.scale, edge_factor=args.edge_factor)


if __name__ == "__main__":
    main()
