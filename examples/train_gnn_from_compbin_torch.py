#!/usr/bin/env python
"""End-to-end GNN training from a CompBin graph on storage, on the
PyTorch/CUDA port.

The port's copy of ``examples/train_gnn_from_compbin.py``: the graph
lives compressed on (simulated slow) storage -> PG-Fuse enlarges + caches
the reads -> packed CompBin bytes cross to the card undecoded -> the CUDA
decode kernel expands them there -> GCN trains full-batch on the
device-resident edge index, every segment sum on the segment-sum kernel
and its gradient on that kernel's backward.  With ``--hosts N`` the load
runs as N simulated processes (``data/multihost.py``), each streaming its
own contiguous slice of the shared partition plan through its own
PG-Fuse cache.  The step is eager: autograd, then AdamW.  Run:

    PYTHONPATH=src python examples/train_gnn_from_compbin_torch.py --steps 60
    PYTHONPATH=src python examples/train_gnn_from_compbin_torch.py --hosts 2
    PYTHONPATH=src python examples/train_gnn_from_compbin_torch.py --sampled
    PYTHONPATH=src python examples/train_gnn_from_compbin_torch.py --device cpu --steps 10

``--sampled`` switches to the random-access regime: minibatch blocks are
drawn through the :mod:`repro_torch.query` neighbor-query engine
(deduplicated, coalesced CompBin reads under the PG-Fuse random-access
policy), with features and seed labels gathered from the column-family
stores on the same mount.  Both regimes stream the label/mask family, so
NO tensor in the batch is synthesized on the host.  ``--device`` defaults
to the GPU and raises without one.
"""

import argparse
import itertools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.convert import stats_ints  # noqa: E402
from repro_torch.core import featstore, paragrapher, policy  # noqa: E402
from repro_torch.data.multihost import (aggregate_stats,  # noqa: E402
                                        all_shards, simulate_hosts)
from repro_torch.graph import (NeighborSampler,  # noqa: E402
                               featstore_for_graph, labelstore_for_graph,
                               rmat, synthesize_node_features,
                               synthesize_separable_labels)
from repro_torch.kernels.utils import resolve_device  # noqa: E402
from repro_torch.launch.data_gnn import (sampled_store_batch,  # noqa: E402
                                         streamed_graph_batch)
from repro_torch.models.gnn import gcn  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten  # noqa: E402
from repro_torch.query import NeighborQueryEngine  # noqa: E402

CONFIG = gcn.GCNConfig(n_layers=2, d_hidden=32, d_in=32, n_classes=8)


def _print_host_stats(results) -> None:
    for r in results:
        st = r.stats
        print(f"  host {r.process_index}: vertices [{r.host_range[0]},"
              f"{r.host_range[1]}) {st.partitions} partitions "
              f"{st.edges:,} edges [{st.decode_mode} decode] "
              f"{st.bytes_h2d/2**10:.0f} KiB H2D, {st.cache_hits} cache "
              f"hits, {st.underlying_reads} storage reads")
    agg = aggregate_stats(results)
    print(f"streamed {agg.edges:,} edges + {agg.feature_rows:,} feature "
          f"rows total: {(agg.bytes_h2d + agg.feature_bytes_h2d)/2**20:.2f} "
          f"MiB H2D, {agg.host_decode_bytes} host-decoded bytes, "
          f"{agg.decode_edges_per_s/1e3:.0f}k edges/s decode, feature "
          f"hit rate {agg.feature_hit_rate:.2f}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--hosts", type=int, default=2,
                    help="simulated streaming processes")
    ap.add_argument("--sampled", action="store_true",
                    help="minibatch sampling instead of full-graph")
    ap.add_argument("--batch-nodes", type=int, default=64)
    ap.add_argument("--workdir", default="/tmp/repro_gnn_example")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap


def run(args, *, device, params=None) -> dict:
    """The example on ``device``, from ``params`` (default:
    ``gcn.init_params`` from seed 0); returns what it printed as
    numbers: the per-host stream stats or the query engine's, and every
    step's loss."""
    os.makedirs(args.workdir, exist_ok=True)
    block_size = 1 << 20
    d_in = 32
    path = os.path.join(args.workdir, "graph.cbin")
    if not os.path.exists(path):
        csr = rmat(12, 8, seed=1)
        paragrapher.save_graph(path, csr, format="compbin")
        print(f"wrote {os.path.getsize(path)/2**20:.1f} MiB CompBin graph")
    feat_path = os.path.join(args.workdir, f"graph_d{d_in}.fst")
    if not os.path.exists(feat_path):
        featstore_for_graph(path, feat_path, d_in, seed=0,
                            data_align=block_size)
        print(f"wrote {os.path.getsize(feat_path)/2**20:.1f} MiB feature "
              f"store ({d_in} float32/row)")
    label_path = os.path.join(args.workdir, "graph_labels.lbl")
    if not os.path.exists(label_path):
        with paragrapher.open_graph(path) as g:
            x = synthesize_node_features(g.n_vertices, d_in, seed=0)
        labelstore_for_graph(path, label_path, 8, seed=0,
                             labels=synthesize_separable_labels(x, 8),
                             data_align=block_size)

    cfg = CONFIG
    if params is None:
        params = gcn.init_params(cfg, torch.Generator().manual_seed(0),
                                 device=device)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps)
    opt = adamw_init(params, opt_cfg)
    rng = np.random.default_rng(0)
    out = {}

    def step(params, opt, batch):
        p = tree_map(lambda v: v.detach().requires_grad_(), params)
        loss = gcn.loss_fn(p, batch, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        params, opt, _ = adamw_update(params, tree_unflatten(p, grads), opt,
                                      opt_cfg)
        return params, opt, loss.detach()

    if args.sampled:
        # random-access regime: adjacency through the query engine
        # (dedup + coalesced span fetches), features + seed labels
        # gathered from the column-family stores on the SAME mount
        amode = policy.choose_access_mode("sample")
        g = paragrapher.open_graph(
            path, use_pgfuse=True, pgfuse_block_size=block_size,
            pgfuse_readahead=amode.readahead,
            pgfuse_eviction=amode.eviction)
        feats = featstore.open_featstore(feat_path, fs=g.fs,
                                         pgfuse_file_readahead=0)
        labels = featstore.open_featstore(label_path, fs=g.fs,
                                          pgfuse_file_readahead=0)
        engine = NeighborQueryEngine(g, device=device)
        sampler = NeighborSampler(engine, fanouts=(10, 5), seed=0)
        print(f"sampled regime: {amode.reason}")

        def batches():
            while True:
                seeds = rng.integers(0, g.n_vertices, args.batch_nodes)
                yield sampled_store_batch("gcn-cora", cfg,
                                          sampler.sample(seeds), feats,
                                          labels, device=device)

        it = batches()
    else:
        # full-graph regime: the streamed shards ARE the training batch —
        # neighbor IDs never exist decoded on the host, and features AND
        # labels ride the same stream; cut vertices snap to the feature
        # block grid so neighboring hosts' caches never double-fetch
        with paragrapher.open_graph(path) as g:
            align = policy.choose_feature_align(block_size, d_in * 4,
                                                g.n_vertices, args.hosts)
        results = simulate_hosts(
            path, args.hosts, device,
            open_kwargs=dict(use_pgfuse=True, pgfuse_block_size=block_size,
                             pgfuse_readahead=2),
            n_buffers=2, readahead=2, feature_path=feat_path,
            label_path=label_path, align=align)
        _print_host_stats(results)
        out["hosts"] = [stats_ints(r.stats) for r in results]
        shards = all_shards(results)
        batch = streamed_graph_batch("gcn-cora", cfg, shards, rng,
                                     n_classes=cfg.n_classes,
                                     n_vertices=results[0].n_vertices)
        it = itertools.repeat(batch)

    t0 = time.time()
    losses = []
    for i in range(1, args.steps + 1):
        params, opt, loss = step(params, opt, next(it))
        losses.append(loss)
        if i % 10 == 0:
            print(f"step {i:4d} loss {float(loss):.4f}")
    dt = time.time() - t0
    out["losses"] = [float(v) for v in losses]
    out["steps_per_s"] = args.steps / dt
    mode = "sampled" if args.sampled else "full-graph"
    print(f"\n{args.steps} {mode} steps in {dt:.1f}s "
          f"({args.steps/dt:.1f} steps/s)")
    if args.sampled:
        st = engine.stats
        print(f"query engine: {st.batches} coalesced batches, dedup "
              f"{st.dedup_ratio:.2f}x, {st.blocks_touched} blocks touched, "
              f"p50 {st.p50_s*1e3:.2f} ms")
        out["engine"] = stats_ints(st)
        engine.close()
        feats.close()
        labels.close()
        g.close()
    return out


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    return run(args, device=resolve_device(args.device))


if __name__ == "__main__":
    main()
