"""Training entry point of the port, on the GPU: LM training from
CompBin-packed token shards, GNN training from CompBin, and DIN.

Wires together ParaGrapher/CompBin/PG-Fuse data loading (token windows
from a packed shard; sampled minibatches, the random-access query
engine, or the full graph streamed on simulated hosts), the LMs (dense
and MoE: the MoE combine on the segment-sum kernel and its backward,
attention on its plain backends, the flash-attention kernel having no
backward) and the GNNs with the segment-sum kernel and its backward,
DIN (its item-table gather and that gather's backward plain PyTorch),
AdamW, async checkpointing with restart, straggler monitoring, and
optional error-feedback gradient compression over the data-parallel
process group (``--compress-grads``: int8 on the wire).

    python -m repro_torch.launch.train --arch smollm-360m --reduced --device cpu --steps 20
    python -m repro_torch.launch.train --arch qwen2-moe-a2.7b --batch 4 --seq 512 --steps 10
    python -m repro_torch.launch.train --arch gcn-cora --reduced --device cpu --steps 20
    python -m repro_torch.launch.train --arch pna --full-graph --hosts 2 --steps 10
    python -m repro_torch.launch.train --arch pna --sampled --steps 10
    python -m repro_torch.launch.train --arch meshgraphnet --steps 10
    python -m repro_torch.launch.train --arch dimenet --steps 10
    python -m repro_torch.launch.train --arch din --reduced --device cpu --steps 10
    python -m repro_torch.launch.train --arch din --batch 65536 --steps 10 --compress-grads

MeshGraphNet and DimeNet train in the default minibatch mode only: the
``--full-graph`` and ``--sampled`` batches carry none of their fields,
and asking for them exits saying so.

``--device cpu`` runs it on the CPU (the kernels' plain versions); the
default is the GPU, and without one it raises.  ``--compress-grads``
runs on the default ``torch.distributed`` process group; where none
exists ``train`` creates a world of one (NCCL on the card, gloo on the
CPU) for the run, so the int8 all-reduces are real collectives either
way.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.distributed.fault_tolerance import (ResilientTrainer,
                                                     StragglerMonitor)
from repro_torch.kernels.utils import resolve_device
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compression, ef_state_init)
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten

log = logging.getLogger("repro_torch.train")


class Batches:
    """An endless iterator of training batches, with what feeds it kept
    in view: ``reader`` for the LMs; ``engine`` under ``--sampled``;
    under ``--full-graph`` the
    simulated hosts' loads (``results``), the one ``batch``, and what the
    hosts were given (``path``, ``feature_path``, ``label_path``,
    ``open_kwargs``, ``align``).  ``close()`` releases the graph handles
    and stores it opened."""

    def __init__(self, gen, closers=(), **parts):
        self._gen = gen
        self._closers = list(closers)
        for k, v in parts.items():
            setattr(self, k, v)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self) -> None:
        while self._closers:
            self._closers.pop()()


# ---------------------------------------------------------------------------
# data generators
# ---------------------------------------------------------------------------

def _lm_batches(cfg, batch: int, seq: int, tmpdir: str, use_pgfuse: bool,
                *, device=None) -> Batches:
    """Token batches from a CompBin-packed shard through PG-Fuse: the JAX
    package's 200,000-token shard (``np.random.default_rng(0)``), random
    ``seq + 1``-token windows (seed 0) decoded on the host, as
    ``{"tokens", "labels"}`` int64 tensors on ``device`` (the window and
    the window shifted by one), two batches prefetched."""
    from repro_torch.data import (PrefetchIterator, TokenShardReader,
                                  write_token_shard)

    device = resolve_device(device)
    path = os.path.join(tmpdir, "tokens.ctok")
    if not os.path.exists(path):
        rng = np.random.default_rng(0)
        write_token_shard(path, rng.integers(0, cfg.vocab, 200_000),
                          cfg.vocab)
    reader = TokenShardReader(path, use_pgfuse=use_pgfuse,
                              pgfuse_block_size=1 << 16)

    def to_device(b):
        t = torch.as_tensor(b, dtype=torch.int64).to(device)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    it = PrefetchIterator(reader.batches(batch, seq, seed=0), depth=2,
                          transform=to_device)
    return Batches(it, closers=[reader.close, it.close], reader=reader)


def _gnn_batches(arch_id: str, cfg, tmpdir: str, use_pgfuse: bool, *,
                 device=None) -> Batches:
    """Minibatch sampling through the ParaGrapher API over CompBin."""
    from repro_torch.core import paragrapher
    from repro_torch.graph import NeighborSampler, rmat
    from repro_torch.launch.data_gnn import block_to_batch

    device = resolve_device(device)
    path = os.path.join(tmpdir, "graph.cbin")
    csr = rmat(10, 8, seed=1)
    if not os.path.exists(path):
        paragrapher.save_graph(path, csr, format="compbin")
    g = paragrapher.open_graph(path, use_pgfuse=use_pgfuse,
                               pgfuse_block_size=1 << 16)
    sampler = NeighborSampler(g, fanouts=(5, 5), seed=0)
    rng = np.random.default_rng(0)

    def gen():
        while True:
            block = sampler.sample(rng.integers(0, csr.n_vertices, 64))
            yield block_to_batch(arch_id, cfg, block, rng, device=device)

    return Batches(gen(), closers=[g.close])


def _gnn_sampled_batches(arch_id: str, cfg, tmpdir: str, use_pgfuse: bool,
                         batch_seeds: int = 64, fanouts=(5, 5), *,
                         device=None, scale: int = 10,
                         edge_factor: int = 8) -> Batches:
    """``--sampled``: minibatch training through the random-access query
    engine.  Adjacency comes from
    :class:`repro_torch.query.NeighborQueryEngine` (deduplicated,
    block-coalesced CompBin reads, each layer's frontier decoded on the
    card by K1 when its edge mass is large enough), features and seed
    labels from the two column-family stores on the SAME PG-Fuse mount
    under the random-access policy; nothing in the batch is synthesized
    on the host.  ``scale``/``edge_factor`` size the generated triplet
    (the JAX package's is rmat(10, 8))."""
    from repro_torch.core import featstore, paragrapher, policy
    from repro_torch.graph import NeighborSampler
    from repro_torch.launch.data_gnn import (ensure_gnn_assets,
                                             refuse_unbuilt_fields,
                                             sampled_store_batch)
    from repro_torch.query import NeighborQueryEngine

    refuse_unbuilt_fields(arch_id, "--sampled")
    device = resolve_device(device)
    d_in = getattr(cfg, "d_in", getattr(cfg, "d_node_in", 16))
    n_classes = getattr(cfg, "n_classes", 7)
    block_size = 1 << 16
    gp, fp, lp = ensure_gnn_assets(tmpdir, d_in, n_classes, scale=scale,
                                   edge_factor=edge_factor,
                                   block_size=block_size)
    amode = policy.choose_access_mode("sample")
    budget = 256 * block_size
    g = paragrapher.open_graph(
        gp, use_pgfuse=use_pgfuse, pgfuse_block_size=block_size,
        pgfuse_readahead=amode.readahead, pgfuse_eviction=amode.eviction,
        pgfuse_max_resident_bytes=budget if use_pgfuse else None)
    closers = [g.close]
    try:
        churn_cap = (int(amode.churn_budget_fraction * budget)
                     if amode.churn_budget_fraction else None)
        feats = featstore.open_featstore(fp, fs=g.fs,
                                         pgfuse_file_budget=churn_cap,
                                         pgfuse_file_readahead=0)
        closers.append(feats.close)
        labels = featstore.open_featstore(lp, fs=g.fs,
                                          pgfuse_file_readahead=0)
        closers.append(labels.close)
        # "auto" decode: each layer's frontier batch picks host vs device
        # by its exact edge mass (policy.choose_query_decode)
        engine = NeighborQueryEngine(g, decode="auto", device=device)
        closers.append(engine.close)
    except BaseException:
        for close in reversed(closers):
            close()
        raise
    sampler = NeighborSampler(engine, fanouts=fanouts, seed=0)
    rng = np.random.default_rng(0)
    n = g.n_vertices
    log.info("sampled mode: %s over %s (|V|=%d); %s", arch_id, gp, n,
             amode.reason)

    def gen():
        step = 0
        while True:
            block = sampler.sample(rng.integers(0, n, batch_seeds))
            yield sampled_store_batch(arch_id, cfg, block, feats, labels,
                                      device=device)
            step += 1
            if step % 50 == 0:
                st = engine.stats
                log.info("query engine after %d batches: dedup %.2fx, "
                         "%d blocks touched, p50 %.2f ms, %d device-"
                         "decoded (%.1f KiB H2D)",
                         st.batches, st.dedup_ratio, st.blocks_touched,
                         st.p50_s * 1e3, st.device_batches,
                         st.bytes_h2d / 1024)

    return Batches(gen(), closers=closers, engine=engine)


def _gnn_full_graph_batches(arch_id: str, cfg, tmpdir: str, use_pgfuse: bool,
                            hosts: int, *, device=None, scale: int = 10,
                            edge_factor: int = 8) -> Batches:
    """Full-graph mode: storage -> PG-Fuse -> packed CompBin + FeatStore
    rows -> device decode (K1) -> :func:`streamed_graph_batch`, on
    ``hosts`` simulated processes.  The whole graph becomes ONE
    device-resident batch; every step is a full-batch epoch.  Neighbor
    IDs, feature rows, AND the label/mask column family all come off
    storage through the same PG-Fuse mount — the batch carries zero
    synthetic tensors.
    """
    from repro_torch.core import paragrapher, policy
    from repro_torch.data.multihost import (aggregate_stats, all_shards,
                                            simulate_hosts)
    from repro_torch.launch.data_gnn import (ensure_gnn_assets,
                                             refuse_unbuilt_fields,
                                             streamed_graph_batch)

    refuse_unbuilt_fields(arch_id, "--full-graph")
    device = resolve_device(device)
    block_size = 1 << 16
    d_in = getattr(cfg, "d_in", getattr(cfg, "d_node_in", 16))
    path, feat_path, label_path = ensure_gnn_assets(
        tmpdir, d_in, getattr(cfg, "n_classes", 7), scale=scale,
        edge_factor=edge_factor, block_size=block_size)
    open_kwargs = dict(use_pgfuse=use_pgfuse, pgfuse_block_size=block_size,
                       pgfuse_readahead=2)
    with paragrapher.open_graph(path) as g:
        align = policy.choose_feature_align(block_size, d_in * 4,
                                            g.n_vertices, hosts)
    results = simulate_hosts(path, hosts, device, open_kwargs=open_kwargs,
                             feature_path=feat_path, label_path=label_path,
                             align=align)
    for r in results:
        st = r.stats
        log.info("host %d/%d: vertices [%d,%d) %d partitions %d edges "
                 "[%s decode] %.1f KiB H2D, %d cache hits, %d storage "
                 "reads, %.1f KiB features (hit rate %.2f)",
                 r.process_index, hosts, *r.host_range, st.partitions,
                 st.edges, st.decode_mode, st.bytes_h2d / 1024,
                 st.cache_hits, st.underlying_reads,
                 st.feature_bytes / 1024, st.feature_hit_rate)
    agg = aggregate_stats(results)
    log.info("streamed %d edges + %d feature rows (%.1f KiB) over %d "
             "host(s): %.1f KiB H2D total, %d host-decoded bytes",
             agg.edges, agg.feature_rows, agg.feature_bytes / 1024, hosts,
             (agg.bytes_h2d + agg.feature_bytes_h2d) / 1024,
             agg.host_decode_bytes)
    if agg.feature_rows != results[0].n_vertices:
        raise RuntimeError(
            f"feature stream incomplete: {agg.feature_rows} rows for "
            f"{results[0].n_vertices} vertices")
    batch = streamed_graph_batch(arch_id, cfg, all_shards(results),
                                 np.random.default_rng(0),
                                 n_classes=getattr(cfg, "n_classes", 7),
                                 n_vertices=results[0].n_vertices)

    def gen():
        while True:
            yield batch

    return Batches(gen(), results=results, batch=batch, path=path,
                   feature_path=feat_path, label_path=label_path,
                   open_kwargs=open_kwargs, align=align)


def _din_batches(cfg, batch: int, *, device=None) -> Batches:
    """DIN click batches, drawn from ``np.random.default_rng(0)`` as the
    JAX package draws them (history ids in [-1, n_items), -1 padding;
    categories, candidates and 0/1 labels uniform): ids as int64 tensors
    on ``device``, labels float32.  The labels are independent of the
    ids, so over fresh batches the loss has nothing to learn."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.int64):
        return torch.as_tensor(a, dtype=dtype).to(device)

    def gen():
        while True:
            yield {
                "hist_items": t(rng.integers(-1, cfg.n_items,
                                             (batch, cfg.seq_len))),
                "hist_cates": t(rng.integers(0, cfg.n_cates,
                                             (batch, cfg.seq_len))),
                "cand_item": t(rng.integers(0, cfg.n_items, batch)),
                "cand_cate": t(rng.integers(0, cfg.n_cates, batch)),
                "labels": t(rng.integers(0, 2, batch).astype(np.float32),
                            torch.float32),
            }

    return Batches(gen())


@contextlib.contextmanager
def process_group(device):
    """The default ``torch.distributed`` process group for
    ``--compress-grads``: the one that exists, or else a world of one
    created here (NCCL for a CUDA ``device``, gloo for the CPU, its
    rendezvous an in-process ``HashStore``) and destroyed on exit."""
    if dist.is_initialized():
        yield dist.group.WORLD
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# step builder
# ---------------------------------------------------------------------------

def _make_step(arch_id: str, cfg, opt_cfg: AdamWConfig, family: str,
               compress_grads: bool = False, *, device=None):
    """``(init_fn, step)``: ``init_fn(seed)`` draws the params on
    ``device`` (None = the GPU; an LM's and DIN's from a generator there,
    a GNN's from a CPU generator); ``step(state, batch) -> (state,
    metrics)`` is one eager forward, backward (autograd; on the card K2's
    backward kernel where the model sums segments) and AdamW update,
    returning new tensors.

    With ``compress_grads`` the gradients go through
    :func:`repro_torch.optim.compression.ef_compress_psum` over the
    default process group (which must exist: :func:`process_group`), the
    loss is averaged over it, and the state carries the residual
    ``ef``."""
    device = resolve_device(device)
    if family == "lm":
        from repro_torch.models import transformer as tf

        def loss_fn(p, b):
            return tf.loss_fn(p, b["tokens"], b["labels"], cfg)

        def init_fn(seed: int = 0) -> dict:
            return tf.init_params(
                cfg, torch.Generator(device=device).manual_seed(seed))
    elif family == "gnn":
        from repro_torch.launch.steps import _GNN_MODULES

        mod = _GNN_MODULES[arch_id]

        def loss_fn(p, b):
            return mod.loss_fn(p, b, cfg)

        def init_fn(seed: int = 0) -> dict:
            return mod.init_params(cfg, torch.Generator().manual_seed(seed),
                                   device=device)
    else:
        from repro_torch.models.recsys import din as m_din

        def loss_fn(p, b):
            return m_din.loss_fn(p, b, cfg)

        def init_fn(seed: int = 0) -> dict:
            return m_din.init_params(
                cfg, torch.Generator(device=device).manual_seed(seed))

    def loss_and_grads(state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(),
                          state["params"])
        loss = loss_fn(params, batch)
        return loss.detach(), tree_unflatten(params, torch.autograd.grad(
            loss, tree_leaves(params)))

    if compress_grads:
        if not dist.is_initialized():
            raise RuntimeError("--compress-grads needs the default process "
                               "group: run the step inside process_group()")
        axis_size = dist.get_world_size()

        def step(state, batch):
            loss, grads = loss_and_grads(state, batch)
            grads, ef = compression.ef_compress_psum(
                grads, state["ef"], axis_size=axis_size)
            loss = loss.reshape(1)
            dist.all_reduce(loss, op=dist.ReduceOp.SUM)
            new, opt, met = adamw_update(state["params"], grads,
                                         state["opt"], opt_cfg)
            return ({"params": new, "opt": opt, "ef": ef},
                    {**met, "loss": loss[0] / axis_size})

        return init_fn, step

    def step(state, batch):
        loss, grads = loss_and_grads(state, batch)
        new, opt, met = adamw_update(state["params"], grads, state["opt"],
                                     opt_cfg)
        return {"params": new, "opt": opt}, {**met, "loss": loss}

    return init_fn, step


def train(arch: str, *, steps: int = 50, reduced: bool = False,
          device=None, batch: int = 8, seq: int = 64,
          full_graph: bool = False, sampled: bool = False,
          hosts: int = 1, ckpt_dir=None, ckpt_every: int = 20,
          inject_failure_at=None, workdir: str = "/tmp/repro_torch_train",
          use_pgfuse: bool = True, compress_grads: bool = False) -> dict:
    """The CLI's training run; returns ``{"losses", "state",
    "step_times_s", "batches"}`` (``batches`` closed).  ``batch`` and
    ``seq`` size an LM's token windows (the JAX package's defaults, 8 x
    64); ``batch`` is DIN's examples a step; a GNN ignores them.  With
    ``compress_grads`` the run holds :func:`process_group`."""
    if full_graph and sampled:
        raise SystemExit("--full-graph and --sampled are mutually exclusive")
    spec = get_arch(arch)
    cfg = spec.make_reduced() if reduced else spec.make_config()
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps,
                          master_f32=True)
    device = resolve_device(device)
    with contextlib.ExitStack() as stack:
        if compress_grads:
            stack.enter_context(process_group(device))
        init_fn, step_fn = _make_step(arch, cfg, opt_cfg, spec.family,
                                      compress_grads, device=device)
        os.makedirs(workdir, exist_ok=True)
        if spec.family == "lm":
            batches = _lm_batches(cfg, batch, seq, workdir, use_pgfuse,
                                  device=device)
        elif spec.family == "recsys":
            batches = _din_batches(cfg, batch, device=device)
        elif full_graph:
            batches = _gnn_full_graph_batches(arch, cfg, workdir, use_pgfuse,
                                              hosts, device=device)
        elif sampled:
            batches = _gnn_sampled_batches(arch, cfg, workdir, use_pgfuse,
                                           device=device)
        else:
            batches = _gnn_batches(arch, cfg, workdir, use_pgfuse,
                                   device=device)
        stack.callback(batches.close)
        params = init_fn(0)
        state = {"params": params, "opt": adamw_init(params, opt_cfg)}
        if compress_grads:
            state["ef"] = ef_state_init(params)
        ckpt_dir = ckpt_dir or os.path.join(workdir, f"ckpt_{arch}")
        trainer = ResilientTrainer(step_fn, state, ckpt_dir=ckpt_dir,
                                   ckpt_every=ckpt_every)
        monitor = StragglerMonitor(n_hosts=1)
        losses, times = [], []

        def on_metrics(step, met):
            monitor.record(0, met["step_time_s"])
            losses.append(float(met["loss"]))
            times.append(met["step_time_s"])
            if step % 10 == 0 or step == steps:
                log.info("step %d loss %.4f grad_norm %.3f lr %.2e (%.0f ms)",
                         step, float(met["loss"]), float(met["grad_norm"]),
                         float(met["lr"]), met["step_time_s"] * 1e3)

        final = trainer.run(batches, n_steps=steps, on_metrics=on_metrics,
                            inject_failure_at=inject_failure_at)
    if losses:
        log.info("done: first-10 mean loss %.4f -> last-10 mean loss %.4f",
                 float(np.mean(losses[:10])), float(np.mean(losses[-10:])))
    return {"losses": losses, "state": final, "step_times_s": times,
            "batches": batches}


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8,
                    help="LM archs: token windows per step; DIN: examples "
                         "per step")
    ap.add_argument("--seq", type=int, default=64,
                    help="LM archs: tokens per window (labels shifted by "
                         "one)")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-scale)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--use-pgfuse", action="store_true", default=True)
    ap.add_argument("--full-graph", action="store_true",
                    help="GNN archs: train full-batch on the streamed "
                         "partition->device pipeline instead of sampled "
                         "minibatches")
    ap.add_argument("--sampled", action="store_true",
                    help="GNN archs: sampled minibatches drawn through "
                         "the random-access query engine, features+labels "
                         "gathered from the column-family stores on the "
                         "shared PG-Fuse mount")
    ap.add_argument("--hosts", type=int, default=1,
                    help="simulated processes for --full-graph streaming "
                         "(data/multihost.py)")
    ap.add_argument("--compress-grads", action="store_true",
                    help="error-feedback int8 gradient all-reduce over the "
                         "default process group (a world of one is "
                         "created where none exists)")
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--workdir", default="/tmp/repro_torch_train")
    args = ap.parse_args(argv)
    try:
        get_arch(args.arch)
    except KeyError as e:
        raise SystemExit(e.args[0]) from None
    train(args.arch, steps=args.steps, reduced=args.reduced,
          device=args.device, batch=args.batch, seq=args.seq,
          full_graph=args.full_graph,
          sampled=args.sampled, hosts=args.hosts, ckpt_dir=args.ckpt_dir,
          ckpt_every=args.ckpt_every,
          inject_failure_at=args.inject_failure_at, workdir=args.workdir,
          use_pgfuse=args.use_pgfuse, compress_grads=args.compress_grads)


if __name__ == "__main__":
    main()
